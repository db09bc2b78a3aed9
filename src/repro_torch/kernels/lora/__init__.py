"""Batched grouped LoRA matmul for the PyTorch port: the CUDA kernel and its
wrapper (module ``bgmv``), the plain version (``ref.py``) and the
device-dispatched entry point ``ops.bgmv``. The package does not re-export
``ops.bgmv``: the name would hide the wrapper module."""
from repro_torch.kernels.lora.ref import bgmv_ref  # noqa: F401
