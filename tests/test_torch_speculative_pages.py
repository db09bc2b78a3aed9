"""Speculative decoding over KIVI pages, with LoRA adapters and on a GQA
model with qkv biases (qwen2.5-32b), vs the port's paged engine and JAX's
speculative engine, on the CPU: the ``PAGE_CASES`` of
``test_torch_speculative.py``'s parity test, which states what each case
holds and why."""
import pytest

from test_torch_speculative import PAGE_CASES, check_spec_case


@pytest.mark.parametrize("case", PAGE_CASES, ids=[c.name for c in PAGE_CASES])
def test_spec_streams_equal_paged_and_jax(case):
    check_spec_case(case)
