"""Helpers of ``chip_smoke.py`` that run without a card: the kernel names
read from the SASS dump's mangled symbols, the SSD scan's bound with and
without the bf16 kernel's per-chunk state traffic, the serving tier's
oracle over a sharded forest's surviving trees, and the comparison of two
replays of one trace event by event."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("mangled,name", [
    ("_ZN46_GLOBAL__N__72ef4e4e_13_flash_attn_cu_38e350b720flash_fwd_mma_"
     "kernelILi5EEEvPK13__nv_bfloat16S3_S3_PS1_iiiiiiiifixxxxxxxxxxxx",
     "flash_fwd_mma_kernelILi5E"),
    ("_ZN46_GLOBAL__N__72ef4e4e_13_flash_attn_cu_38e350b716flash_fwd_kernel"
     "IfLi8EEEvPKT_S3_S3_PS1_iiiiiiifxxxxxxxxxxxx", "flash_fwd_kernelIfLi8E"),
    ("_ZN38_GLOBAL__N__36555feb_6_ssd_cu_339a593822ssd_chunk_state_kernel"
     "EPK13__nv_bfloat16PKfS2_PfS5_iiiiiiiixxxxxxxx",
     "ssd_chunk_state_kernel"),
    ("_Z6helperv", "_Z6helperv"),
])
def test_kernel_name_from_mangled_symbol(mangled, name):
    assert chip_smoke.kernel_name(mangled) == name
    bf16 = ("flash_fwd_mma_kernel", "ssd_chunk_state_kernel",
            "ssd_chunk_out_kernel")
    assert any(name.startswith(n) for n in bf16) == (
        name in ("flash_fwd_mma_kernelILi5E", "ssd_chunk_state_kernel"))


def test_ssd_bound_counts_the_state_traffic():
    """Bsz 2, S 300 (3 chunks of 128), H 4, P 8, N 16, bf16: inputs and
    outputs once; with the states (f32) and h_in (bf16 hi + lo) written
    and read, 16 bytes per element of (Bsz, H, chunks, N, P)."""
    x = torch.zeros(2, 300, 4, 8, dtype=torch.bfloat16)
    alog = torch.zeros(2, 300, 4)
    B = C = torch.zeros(2, 300, 16, dtype=torch.bfloat16)
    ms, by, work = chip_smoke.ssd_bound(x, alog, B, C, chunk=128)
    n_bytes = (2 * x.numel() + 2 * B.numel()) * 2 + alog.numel() * 4 \
        + 2 * 4 * 16 * 8 * 4
    assert work["bytes"] == n_bytes and by == "bytes"
    assert work["state_bytes"] == 16 * 2 * 4 * 3 * 16 * 8
    assert ms == pytest.approx(n_bytes / chip_smoke.HBM_BYTES_PER_S * 1e3)
    assert work["bound_with_states_ms"] == pytest.approx(
        (n_bytes + work["state_bytes"]) / chip_smoke.HBM_BYTES_PER_S * 1e3)


def test_plain_subset_is_the_mean_of_its_trees():
    """The serving-tier oracle: over every tree it is ``plain_cpu``, bit for
    bit; over the survivors of a drop, the mean of those trees."""
    import numpy as np

    from repro_torch.core.forest import ExtraTreesRegressor
    from repro_torch.core.forest_torch import to_dense
    rng = np.random.default_rng(1)
    X = rng.lognormal(1.0, 1.5, size=(60, 5)).astype(np.float32)
    y = np.log(2 * X[:, 0] + X[:, 2] + 1.0)
    est = ExtraTreesRegressor(n_estimators=7, max_depth=5, seed=0).fit(X, y)
    dense = to_dense(est, chip_smoke.DEPTH)
    np.testing.assert_array_equal(chip_smoke.plain_subset(dense, range(7), X),
                                  chip_smoke.plain_cpu(est, X))
    live = [1, 3, 4]
    np.testing.assert_allclose(
        chip_smoke.plain_subset(dense, live, X),
        np.mean([est.trees_[i].predict(X) for i in live], axis=0),
        rtol=1e-5)


def test_replay_mismatches_flags_each_difference():
    from repro_torch.workloads.trace import EventOutcome, ReplayReport

    def report(*outcomes):
        return ReplayReport("t", "sequential", 1.0, list(outcomes), {}, 0.0)
    base = [EventOutcome(0, "a", "k0", "served", 2.5),
            EventOutcome(1, "b", "k1", "shed"),
            EventOutcome(2, "a", "k2", "served", -1.0)]
    host = report(*base)
    assert chip_smoke.replay_mismatches(host, report(*base)) == []
    near = EventOutcome(0, "a", "k0", "served", 2.5 * (1 + 1e-7))
    assert chip_smoke.replay_mismatches(host, report(near, *base[1:])) == []
    far = EventOutcome(0, "a", "k0", "served", 2.5 * (1 + 1e-4))
    shed = EventOutcome(2, "a", "k2", "shed")
    off = chip_smoke.replay_mismatches(
        host, report(far, shed, EventOutcome(7, "a", "k7", "served", 1.0)))
    assert [i for i, _ in off] == [0, 1, 2, 7]
