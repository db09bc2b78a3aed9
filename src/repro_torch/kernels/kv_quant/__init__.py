"""Per-page KIVI quantization for the PyTorch port: the CUDA pack and unpack
kernels and their wrapper (``kv_quant.py``), the plain versions
(``ref.py``) and the device-dispatched entry points (``ops.py``)."""
from repro_torch.kernels.kv_quant.ops import (  # noqa: F401
    dequantize_kv_pages,
    quantize_kv_pages,
)
from repro_torch.kernels.kv_quant.ref import (  # noqa: F401
    dequantize_pages_ref,
    quantize_pages_ref,
)
