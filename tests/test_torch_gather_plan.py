"""The gather-distance kernels' schedule plan, held without a card.

``gather_distance.plan`` and ``quantized_gather_distance.plan`` pick the
``"tiled"`` schedule (a block per lane and tile of 64 candidates) when
that grid, B * ceil(K / 64) blocks, has a block for each SM (the int8
kernel: for 3/4 of them), and the ``"spread"`` one (a warp per candidate)
below it; and 16-byte loads only
for rows that are 16-byte aligned. Here: the threshold on either side,
every launch shape of ``chip_smoke.py``'s batched search and build, the
build's morsels, the load width, the launch counters, and that each
wrapper hands its plan to the C entry (with the launch itself stubbed).
That CPU tensors count no launch is held by ``test_torch_dispatch.py``.
"""

import pytest
import torch

import chip_smoke
from repro_torch.configs.navix_paper import PAPER_INDEX
from repro_torch.core.build import _batch_schedule
from repro_torch.kernels import (_build, gather_distance,
                                 quantized_gather_distance)

KERNELS = {"f32": gather_distance, "int8": quantized_gather_distance}
#: (batched entry, one-lane entry) of each kernel's wrapper
ENTRIES = {"f32": (gather_distance.gather_distance_batch,
                   gather_distance.gather_distance),
           "int8": (quantized_gather_distance.quantized_gather_distance_batch,
                    quantized_gather_distance.quantized_gather_distance)}
H100_SMS = 132
M_U = PAPER_INDEX.m_u
M_L = 2 * M_U
P_CAP = PAPER_INDEX.build_params().new_edge_cap
# K of the build's launches: seeds, upper descent, beam iterations, and the
# upper and lower levels' edge merges
BUILD_KS = (1, M_U, M_L, M_U + P_CAP, M_L + P_CAP)


# (kernel, SMs, B, K, schedule): one block below and at the threshold,
# reached by lanes, by tiles of 64 candidates or by both. The f32 kernel
# switches at the SM count, the int8 kernel at 3/4 of it (99 blocks of
# 132; 85.5 of the H100 PCIe's 114)
@pytest.mark.parametrize("kernel,sms,bsz,k,want", [
    ("f32", H100_SMS, 1, 64, "spread"), ("f32", H100_SMS, 1, 1, "spread"),
    ("f32", H100_SMS, 131, 64, "spread"), ("f32", H100_SMS, 132, 64, "tiled"),
    ("f32", H100_SMS, 131, 1, "spread"), ("f32", H100_SMS, 132, 1, "tiled"),
    ("f32", H100_SMS, 65, 72, "spread"), ("f32", H100_SMS, 66, 72, "tiled"),
    ("f32", H100_SMS, 1, 64 * 131, "spread"),
    ("f32", H100_SMS, 1, 64 * 131 + 1, "tiled"),
    ("f32", H100_SMS, 1024, 64, "tiled"), ("f32", 114, 113, 64, "spread"),
    ("f32", 114, 114, 64, "tiled"), ("f32", 114, 56, 72, "spread"),
    ("f32", 114, 57, 72, "tiled"),
    ("int8", H100_SMS, 1, 64, "spread"), ("int8", H100_SMS, 32, 64, "spread"),
    ("int8", H100_SMS, 98, 64, "spread"), ("int8", H100_SMS, 99, 64, "tiled"),
    ("int8", H100_SMS, 98, 1, "spread"), ("int8", H100_SMS, 99, 1, "tiled"),
    ("int8", H100_SMS, 49, 72, "spread"), ("int8", H100_SMS, 50, 72, "tiled"),
    ("int8", H100_SMS, 1, 64 * 98, "spread"),
    ("int8", H100_SMS, 1, 64 * 98 + 1, "tiled"),
    ("int8", H100_SMS, 128, 64, "tiled"), ("int8", 114, 85, 64, "spread"),
    ("int8", 114, 86, 64, "tiled")])
def test_schedule_threshold(kernel, sms, bsz, k, want):
    """B * ceil(K / 64) at or above the kernel's share of the SM count
    gives "tiled", one block fewer "spread"; the width does not enter."""
    for d in (960, 33):
        assert KERNELS[kernel].plan(bsz, k, d, sms)[0] == want


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("bsz,k", chip_smoke._kernel_shapes())
def test_main_path_launches_are_tiled(kernel, bsz, k):
    """Every (B, K) of the batched search and the build's full morsels
    (``chip_smoke._kernel_shapes``) fills an H100 on the tiled grid."""
    assert KERNELS[kernel].plan(bsz, k, chip_smoke.DIM, H100_SMS)[0] \
        == "tiled"


@pytest.mark.parametrize("level,n_total,morsel", [
    ("lower", chip_smoke.N, chip_smoke.BUILD_MORSEL),
    # the upper level: a 5% sample in morsels of _build_level's default 256
    ("upper", round(chip_smoke.N * PAPER_INDEX.sample_rate), 256)])
def test_build_morsels_schedule(level, n_total, morsel):
    """In a 1M build, morsels of fewer than 132 nodes (the doubling
    warm-up 1 .. 128, and the upper level's last morsel of 80) run on the
    spread schedule at every K up to one tile; full morsels and the lower
    level's last one run tiled at every K of the build."""
    sizes = [hi - lo for lo, hi in _batch_schedule(n_total, 1, morsel)]
    doubling = [2 ** i for i in range(morsel.bit_length() - 1)]
    assert sizes[:len(doubling)] == doubling
    assert set(sizes[len(doubling):-1]) == {morsel}
    assert (level == "upper") == (sizes[-1] < H100_SMS)
    warm = [b for b in sizes if b < H100_SMS]
    assert warm[:8] == doubling[:8] == [1, 2, 4, 8, 16, 32, 64, 128]
    for k in BUILD_KS:
        for b in sizes:
            if b >= H100_SMS:             # 256 .. 1024, full, lower's last
                assert gather_distance.plan(b, k, 960, H100_SMS)[0] \
                    == "tiled"
        for b in warm:
            want = "spread" if k <= 64 else (
                "tiled" if 2 * b >= H100_SMS else "spread")
            assert gather_distance.plan(b, k, 960, H100_SMS)[0] == want


@pytest.mark.parametrize("kernel,d,offset,vec", [
    ("f32", 960, 0, True), ("f32", 33, 0, False), ("f32", 36, 0, True),
    ("f32", 960, 1, False), ("f32", 960, 4, True),
    ("int8", 960, 0, True), ("int8", 33, 0, False), ("int8", 36, 0, False),
    ("int8", 48, 0, True), ("int8", 960, 1, False)])
def test_plan_load_width(kernel, d, offset, vec):
    """16-byte loads need d % 4 == 0 (f32) or d % 16 == 0 (int8 codes) and
    every base pointer 16-byte aligned; an offset view of 1 element (4
    bytes of Q) takes 4-byte loads, one of 4 elements keeps 16."""
    buf = torch.zeros((2 * d + 8,), dtype=torch.float32)
    assert buf.data_ptr() % 16 == 0
    Q = buf[offset:offset + d].view(1, d)
    rows = (torch.zeros((4, d)) if kernel == "f32"
            else torch.zeros((4, d), dtype=torch.int8))
    assert rows.data_ptr() % 16 == 0
    _, got = KERNELS[kernel].plan(1, 64, d, H100_SMS, Q.data_ptr(),
                                  rows.data_ptr())
    assert got is vec


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_path_launches_keys(kernel):
    mod = KERNELS[kernel]
    assert set(mod.PATH_LAUNCHES) == {"tiled", "spread"} \
        == set(_build.SCHEDULE_CODE)
    assert all(isinstance(v, int) for v in mod.PATH_LAUNCHES.values())


def _stub_launch(monkeypatch, sms=H100_SMS):
    """Stub the card out of the wrappers: CPU tensors pass the input check
    and each launch records its arguments instead of running."""
    calls = []
    monkeypatch.setattr(_build, "check_cuda_inputs", lambda *a, **k: None)
    monkeypatch.setattr(_build, "sm_count", lambda device: sms)
    monkeypatch.setattr(_build, "launch",
                        lambda name, fn, device, *args: calls.append(args))
    for mod in KERNELS.values():
        monkeypatch.setattr(mod, "_kernel", lambda: None)
        monkeypatch.setattr(mod, "PATH_LAUNCHES", {"tiled": 0, "spread": 0})
    return calls


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("entry,bsz,k,want", [
    ("batch", 1024, 64, "tiled"), ("batch", 64, 64, "spread"),
    ("batch", 66, 72, "tiled"), ("one_lane", 1, 64, "spread"),
    ("one_lane", 1, 1, "spread"), ("named", 1, 64, "tiled"),
    ("named", 1024, 64, "spread")])
def test_wrapper_hands_its_plan_to_the_c_entry(monkeypatch, kernel, entry,
                                               bsz, k, want):
    """The schedule code and the load width reach the C entry's last two
    int arguments; each launch counts once in ``PATH_LAUNCHES`` under its
    schedule, and in ``LAUNCHES`` or ``ONE_LANE_LAUNCHES`` by entry. A
    named schedule (measurements only) overrides the plan."""
    calls = _stub_launch(monkeypatch)
    mod = KERNELS[kernel]
    d = 960
    Q = torch.zeros((bsz, d))
    ids = torch.zeros((bsz, k), dtype=torch.int32)
    rows = torch.zeros((8, d))
    args = (rows,) if kernel == "f32" else (
        rows.to(torch.int8), torch.ones((8,)))
    counts = (mod.LAUNCHES, mod.ONE_LANE_LAUNCHES)
    batched, one_lane = ENTRIES[kernel]
    if entry == "batch":
        batched(Q, *args, ids, "l2")
    elif entry == "one_lane":
        one_lane(Q[0], *args, ids[0], "l2")
    else:
        mod._launch(Q, *args, ids, "l2", want)
    (call,) = calls
    assert call[-2:] == (_build.SCHEDULE_CODE[want], 1)
    assert mod.PATH_LAUNCHES == {s: int(s == want) for s in mod.PATH_LAUNCHES}
    assert (mod.LAUNCHES - counts[0], mod.ONE_LANE_LAUNCHES - counts[1]) \
        == {"batch": (1, 0), "one_lane": (0, 1), "named": (0, 0)}[entry]
