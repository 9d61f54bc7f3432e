"""The dry run on 8 fake ranks, (2, 4) ("data", "model"), for the reduced
hybrid config: train (2 microbatches), prefill and decode come out ``ok``
with the reference's record keys (``tests/_torch_dryrun.py``); then what
the tallies count: nothing on a (1, 1) mesh, and on (2, 4) a train step's
gradient reductions."""
import pytest

from _torch_dryrun import check_record, small_records


@pytest.mark.parametrize("arch", ["hymba_1_5b"])
def test_small_cells_run(arch):
    recs = small_records([arch])
    assert [r["shape"] for r in recs] == ["train", "prefill", "decode"]
    for rec in recs:
        check_record(rec)


def test_one_rank_moves_nothing():
    """On a (1, 1) mesh every axis has one rank: no collective moves a
    byte."""
    for rec in small_records(["deepseek_7b"], data=1, model=1):
        check_record(rec, n_chips=1)
        assert all(v == {"count": 0, "result_bytes": 0.0, "wire_bytes": 0.0}
                   for v in rec["roofline"]["collectives"].values()), rec["shape"]
        assert rec["roofline"]["collective_s"] == 0.0


def test_a_train_step_counts_its_gradient_reductions():
    """deepseek-7b reduced on (2, 4), 2 microbatches: every parameter's
    gradient is reduced over "data" (the batch's axis) once a microbatch,
    an all-reduce where the parameter is replicated over it and a
    reduce-scatter where FSDP shards it."""
    from repro_torch.configs import get_config
    from repro_torch.launch.cells import params_spec_for

    n_params = len(list(params_spec_for(get_config("deepseek_7b").reduced()).parameters()))
    rec = next(r for r in small_records(["deepseek_7b"]) if r["shape"] == "train")
    t = rec["roofline"]["collectives"]
    assert rec["microbatches"] == 2
    assert t["reduce-scatter"]["count"] + t["all-reduce"]["count"] >= 2 * n_params
    assert t["reduce-scatter"]["count"] > 0 and t["all-gather"]["count"] > 0
