"""Causal flash prefill attention for the PyTorch port: the CUDA kernel and
its wrapper (module ``flash_attention``), the plain version (``ref.py``)
and the device-dispatched entry point ``ops.flash_prefill``."""
from repro_torch.kernels.flash_attention.ops import flash_prefill  # noqa: F401
from repro_torch.kernels.flash_attention.ref import flash_prefill_ref  # noqa: F401
