"""The dry run on 8 fake ranks, (2, 4) ("data", "model"), for the reduced
SSM, dense and grouped-query configs: train (2 microbatches), prefill and
decode come out ``ok`` with the reference's record keys
(``tests/_torch_dryrun.py``)."""
import pytest

from _torch_dryrun import check_record, small_records


@pytest.mark.parametrize("arch", ["mamba2_130m", "internlm2_20b", "deepseek_7b", "gemma2_9b",
                                  "qwen2_72b"])
def test_small_cells_run(arch):
    recs = small_records([arch])
    assert [r["shape"] for r in recs] == ["train", "prefill", "decode"]
    for rec in recs:
        check_record(rec)
