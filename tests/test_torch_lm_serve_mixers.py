"""The port's LM serving path against the reference on the CPU, for the
architectures whose mixer or FFN is not a dense attention block: mamba2
(SSD), hymba (attention + SSD, sliding windows), arctic and kimi (MoE;
kimi's dense first layer), seamless (encoder-decoder, cross attention).
The same checks as ``test_torch_lm_serve.py``; tolerances:
``tests/_torch_lm.py``.
"""
import pytest

from _torch_lm import ServeParity, check_incremental_equals_full


@pytest.mark.parametrize("arch", ["mamba2_130m", "hymba_1_5b", "arctic_480b", "kimi_k2_1t_a32b",
                                  "seamless_m4t_medium"])
class TestServeParity(ServeParity):
    pass


@pytest.mark.parametrize("arch", ["mamba2_130m", "hymba_1_5b", "kimi_k2_1t_a32b",
                                  "seamless_m4t_medium"])
def test_incremental_equals_full(arch):
    check_incremental_equals_full(arch)
