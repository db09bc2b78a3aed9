from repro_torch.models.model import (  # noqa: F401
    Model,
    build_model,
    paged_decode_supported,
)
