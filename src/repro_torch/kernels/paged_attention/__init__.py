"""Paged attention for the PyTorch port: the CUDA kernel and its wrapper
(``paged_attention.py``), the plain oracles (``ref.py``) and the
device-dispatched entry points (``ops.py``)."""
from repro_torch.kernels.paged_attention.ops import (  # noqa: F401
    paged_attend,
    paged_attend_extend,
    paged_attend_extend_folded,
    paged_decode_attention,
)
from repro_torch.kernels.paged_attention.ref import (  # noqa: F401
    paged_attention_chunked_ref,
    paged_attention_ref,
)
