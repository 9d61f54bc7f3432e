"""The port's LM serving path against the reference on the CPU: the
dense, GQA-with-bias, local/global and VLM architectures at
``reduced(ssm_chunk=8)`` (B = 2, S = 24) on the reference's weights
(``convert.lm_params_from_reference``): ``prefill`` and 3 serve steps
(logits and caches), ``forward``, decoding on from the reference's prefill
cache (``convert.lm_cache_from_reference``), the cache's length, the
greedy tokens, and the port's own incremental-equals-full. Tolerances:
``tests/_torch_lm.py``. The SSM, hybrid, MoE and encoder-decoder
architectures: ``test_torch_lm_serve_mixers.py``; bf16:
``test_torch_lm_serve_bf16.py``.
"""
import pytest

from _torch_lm import ServeParity, check_incremental_equals_full

ARCHS = ["deepseek_7b", "gemma2_9b", "internlm2_20b", "qwen2_72b", "internvl2_76b"]


@pytest.mark.parametrize("arch", ARCHS)
class TestServeParity(ServeParity):
    pass


@pytest.mark.parametrize("arch", ARCHS)
def test_incremental_equals_full(arch):
    check_incremental_equals_full(arch)
