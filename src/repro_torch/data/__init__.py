from repro_torch.data.synthetic import SyntheticLM, make_batches  # noqa: F401
from repro_torch.data.tokenizer import ByteTokenizer  # noqa: F401
