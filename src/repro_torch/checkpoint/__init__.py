from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint  # noqa: F401
from repro_torch.checkpoint.serving_state import ServingStateLog  # noqa: F401
