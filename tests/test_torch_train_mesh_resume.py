"""An SPMD trainer survives preemption: ``chip_smoke.TRAIN_MESH_SCRIPT``
(the rank script phase 34 runs on the card at the flagship's size) runs
here on the CPU at a tiny size as 2 gloo ranks on (fsdp 2), each started
with the orchestrator's variables (the norms and counters replicate, so
rank 0 alone writes them). Killed, every rank, as soon as
a step's shard files are all published, and started again, each rank
restores its blocks from the sharded checkpoint, continues the batch
sequence, and ends with the uninterrupted run's blocks bit for bit (the
CPU's sums are deterministic), its losses equal."""

import numpy as np

import chip_smoke

TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
            d_ff=64)
RANKS, STEPS = 2, 20


def _config(tag: str) -> dict:
    return chip_smoke.mesh_trainer_config(
        "cpu", ("resume",), resume_model=TINY, resume_dtype="float32",
        axes=("fsdp",), sizes=(RANKS,), batch=4, seq=128, steps=STEPS,
        save_every=2, tag=tag)


def _steps(events) -> dict:
    return {e["step"]: e["loss"] for e in events if e["event"] == "step"}


def test_killed_spmd_trainer_resumes_bit_for_bit(tmp_path):
    whole, killed = tmp_path / "whole", tmp_path / "killed"
    whole.mkdir()
    killed.mkdir()
    run = chip_smoke.launch_mesh_ranks(whole, _config("whole"), RANKS,
                                       "whole", timeout_s=120)
    losses = _steps(run["events"][0])
    assert sorted(losses) == list(range(1, STEPS + 1))
    assert all(_steps(r) == losses for r in run["events"])
    first = chip_smoke.launch_mesh_ranks(killed, _config("killed"), RANKS,
                                         "killed", until="published",
                                         timeout_s=120)
    # Killed inside the loop, before any rank finished.
    assert not any(e["event"] == "done" for r in first["events"] for e in r)
    second = chip_smoke.launch_mesh_ranks(killed, _config("second"), RANKS,
                                          "second", timeout_s=120)
    for events in second["events"]:
        (restored,) = [e for e in events if e["event"] == "restored"]
        start = restored["step"]
        assert 2 <= start < STEPS and start % 2 == 0
        got = _steps(events)
        assert sorted(got) == list(range(start + 1, STEPS + 1))
        assert all(losses[s] == loss for s, loss in got.items())
    for rank in range(RANKS):
        a = np.load(whole / f"final-whole-{rank}.npz")
        b = np.load(killed / f"final-second-{rank}.npz")
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
