"""The port's LM serving path in bf16 against the reference on the CPU:
deepseek-7b ``reduced(ssm_chunk=8, dtype="bfloat16")``, the checks of
``test_torch_lm_serve.py`` at rtol 2e-2 and atol 2e-3 (in units of the
logits' scale), against the reference's layers run as a Python loop
(``tests/_torch_lm.py`` says why).
"""
import pytest

from _torch_lm import ServeParity, check_incremental_equals_full


@pytest.mark.parametrize("arch", ["deepseek_7b"])
class TestServeParityBf16(ServeParity):
    dtype = "bfloat16"


def test_incremental_equals_full_bf16():
    check_incremental_equals_full("deepseek_7b", "bfloat16")
