"""Paged attention for the PyTorch port: the CUDA kernels and their wrappers
(``paged_attention.py`` over fp pages, ``paged_attention_quant.py`` over
KIVI pages), the plain oracles (``ref.py``) and the device-dispatched entry
points (``ops.py``)."""
from repro_torch.kernels.paged_attention.ops import (  # noqa: F401
    paged_attend,
    paged_attend_extend,
    paged_attend_extend_folded,
    paged_attend_extend_quant,
    paged_attend_quant,
    paged_decode_attention,
    paged_decode_attention_quant,
)
from repro_torch.kernels.paged_attention.ref import (  # noqa: F401
    dequantize_page_leaves,
    paged_attention_chunked_quant_ref,
    paged_attention_chunked_ref,
    paged_attention_quant_ref,
    paged_attention_ref,
)
