"""Kernel 6's wrapper rule and the arithmetic its two paths rest on, with no
card: ``quantized.plan`` (the path by batch size, the load width by row
width and alignment), the range checks, what the wrapper hands each C entry,
the exact int8-to-f32 conversion of both sources, the precision of
splitting Q into TF32 or BF16 pieces against exact int8 codes at d = 960,
and what ``chip_smoke.py`` holds the kernel to (its sources, bounds, sweep
and float64 reference).
"""

import pathlib

import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.kernels import _build, ops, quantized

T = quantized.STREAM_MAX_BATCH
RNG = np.random.default_rng(0)
CSRC = pathlib.Path(quantized.__file__).resolve().parent / "csrc"


def _q(b, d, offset=0):
    """f32 Q[b, d], starting ``offset`` floats into its storage."""
    return torch.zeros((b * d + offset,))[offset:].view(b, d)


def _codes(n, d, offset=0):
    """int8 codes[n, d], starting ``offset`` bytes into their storage."""
    return torch.zeros((n * d + offset,), dtype=torch.int8)[offset:].view(n,
                                                                          d)


@pytest.mark.parametrize("b,path", [(1, "stream"), (2, "stream"),
                                    (T - 1, "stream"), (T, "stream"),
                                    (T + 1, "wgmma"), (2 * T, "wgmma"),
                                    (1024, "wgmma")])
def test_plan_picks_the_path_at_the_threshold(b, path):
    """b <= STREAM_MAX_BATCH streams the codes, larger batches run on the
    tensor cores."""
    assert quantized.plan(_q(b, 960), _codes(5, 960)) == (path, 16)


def test_threshold_is_kernel_6s_own():
    """The int8 threshold comes from kernel 6's own sweep: its streaming
    path carries 2b flops a byte of codes, not kernel 5's b / 2."""
    assert 1 <= T < quantized.MAX_BATCH
    assert set(quantized.PATH_LAUNCHES) == {"stream", "wgmma"}
    assert all(isinstance(v, int) for v in quantized.PATH_LAUNCHES.values())


@pytest.mark.parametrize("d,width", [(960, 16), (64, 16), (16, 16),
                                     (100, 4), (36, 4), (4, 4),
                                     (61, 1), (33, 1), (1, 1), (962, 1)])
def test_plan_takes_16_byte_loads_only_for_rows_of_16_bytes(d, width):
    """16-byte loads where d % 16 == 0, 4-byte copies of the codes where
    d % 4 == 0, byte loads of the codes otherwise."""
    assert quantized.plan(_q(3, d), _codes(7, d))[1] == width


@pytest.mark.parametrize("q_off,c_off,width", [
    (1, 0, 4), (2, 0, 4), (0, 4, 4), (0, 8, 4), (1, 4, 4),
    (0, 1, 1), (0, 2, 1), (0, 3, 1), (1, 1, 1), (0, 0, 16)])
def test_plan_reads_the_alignment_of_views(q_off, c_off, width):
    """d % 16 == 0 is not enough: a view that starts off a 16-byte boundary
    takes the 4-byte copies, and codes off a 4-byte boundary byte loads."""
    d = 64
    Q, codes = _q(3, d, q_off), _codes(7, d, c_off)
    assert quantized.plan(Q, codes) == ("stream", width)
    assert quantized.plan(Q.clone(), codes.clone()) == ("stream", 16)


def _wide(rows, d=4, dtype=torch.float32):
    """A [rows, d] view of one stored row: no memory for huge rows."""
    return torch.zeros((1, d), dtype=dtype).expand(rows, d)


@pytest.mark.parametrize("Q,codes,scale,metric,error", [
    (torch.zeros((2, 4), dtype=torch.float64),
     torch.zeros((3, 4), dtype=torch.int8), torch.zeros(3), "l2",
     TypeError),                                      # Q's dtype
    (torch.zeros((2, 4)), torch.zeros((3, 4)), torch.zeros(3), "l2",
     TypeError),                                      # codes' dtype
    (torch.zeros((2, 4)), torch.zeros((3, 4), dtype=torch.int8),
     torch.zeros(3, dtype=torch.float64), "l2", ValueError),   # scale dtype
    (torch.zeros((2, 4)), torch.zeros((3, 4), dtype=torch.int8),
     torch.zeros(4), "l2", ValueError),               # scale's length
    (torch.zeros((2, 4)), torch.zeros((3, 5), dtype=torch.int8),
     torch.zeros(3), "l2", ValueError),               # widths
    (torch.zeros((2, 0)), torch.zeros((3, 0), dtype=torch.int8),
     torch.zeros(3), "l2", ValueError),               # d = 0
    (torch.zeros((2, 4)), torch.zeros((3, 4), dtype=torch.int8),
     torch.zeros(3), "ip", ValueError),               # metric
    (_wide(2 ** 31), torch.zeros((3, 4), dtype=torch.int8), torch.zeros(3),
     "dot", ValueError),                              # b past MAX_BATCH
    (torch.zeros((2, 4)), _wide(2 ** 31, dtype=torch.int8),
     torch.zeros(1).expand(2 ** 31), "dot", ValueError),          # n
])
def test_range_checks_raise_without_a_card(Q, codes, scale, metric, error):
    with pytest.raises(error):
        quantized.check_shapes(Q, codes, scale, metric)


def test_max_batch_passes_the_checks():
    quantized.check_shapes(_wide(quantized.MAX_BATCH),
                           torch.zeros((3, 4), dtype=torch.int8),
                           torch.zeros(3), "l2")


def _stub_launch(monkeypatch):
    """Stub the card out of the wrapper: CPU tensors pass the input check
    and each launch records its C entry's path and arguments."""
    calls = []
    monkeypatch.setattr(_build, "check_cuda_inputs", lambda *a, **k: None)
    monkeypatch.setattr(_build, "launch", lambda name, fn, device, *args:
                        calls.append((fn, args)))
    monkeypatch.setattr(quantized, "_kernel", lambda path: path)
    monkeypatch.setattr(quantized, "_scratch_bytes", lambda b, d: 16)
    monkeypatch.setattr(quantized, "PATH_LAUNCHES",
                        {"stream": 0, "wgmma": 0})
    return calls


@pytest.mark.parametrize("metric", ["l2", "cos", "dot"])
@pytest.mark.parametrize("b,d,named,want,width", [
    (1, 960, None, "stream", 16), (T, 61, None, "stream", 1),
    (T + 1, 100, None, "wgmma", 4), (1024, 960, None, "wgmma", 16),
    (1, 960, "wgmma", "wgmma", 16), (1024, 33, "stream", "stream", 1)])
def test_wrapper_hands_its_plan_to_the_c_entry(monkeypatch, metric, b, d,
                                               named, want, width):
    """The path picks the C entry; b, n, d, the metric code and the load
    width reach its int arguments; each launch counts once in
    ``PATH_LAUNCHES`` under its path, and in ``LAUNCHES`` only through the
    public entry. A named path (measurements only) overrides the plan."""
    calls = _stub_launch(monkeypatch)
    Q, codes, scale = _q(b, d), _codes(7, d), torch.ones(7)
    before = quantized.LAUNCHES
    if named is None:
        out = quantized.quantized_distance_matrix(Q, codes, scale, metric)
    else:
        out = quantized._launch(Q, codes, scale, metric, named)[0]
    assert out.shape == (b, 7) and out.dtype == torch.float32
    ((fn, args),) = calls
    assert fn == want
    assert args[-5:] == (b, 7, d, _build.METRIC_CODE[metric], width)
    # Q, codes, scale, out, and the wgmma path's scratch for Q's split
    assert len(args) == 5 + 4 + (want == "wgmma")
    assert quantized.PATH_LAUNCHES == {p: int(p == want)
                                       for p in quantized.PATH_LAUNCHES}
    assert quantized.LAUNCHES - before == int(named is None)


def test_empty_batch_launches_nothing(monkeypatch):
    calls = _stub_launch(monkeypatch)
    before = quantized.LAUNCHES
    out = quantized.quantized_distance_matrix(
        _q(0, 16), _codes(5, 16), torch.ones(5), "l2")
    assert out.shape == (0, 5) and not calls
    assert quantized.LAUNCHES == before


def test_cpu_entry_counts_no_launch():
    before = quantized.LAUNCHES, dict(quantized.PATH_LAUNCHES)
    Q = torch.from_numpy(RNG.normal(size=(3, 16)).astype(np.float32))
    codes = torch.from_numpy(RNG.integers(-127, 128, (5, 16)).astype(np.int8))
    ops.quantized_distance_matrix(Q, codes, torch.ones(5), "l2")
    assert (quantized.LAUNCHES, quantized.PATH_LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA tensors only"):
        quantized.quantized_distance_matrix(Q, codes, torch.ones(5), "l2")


# ---------------------------------------------------------------------------
# the arithmetic both sources rest on
# ---------------------------------------------------------------------------

CODES = torch.arange(-128, 128, dtype=torch.int32)


def test_byte_perm_conversion_is_exact():
    """Each code, biased by 128 into the mantissa of 2^23 (the float with
    bits 0x4b0000uu), less 2^23 + 128, is the code itself, for all 256."""
    bits = 0x4B000000 | ((CODES ^ -128) & 0xFF)        # (c ^ 0x80) = c + 128
    got = bits.view(torch.float32) - torch.tensor(8388736.0)
    assert torch.equal(got, CODES.to(torch.float32))


def _tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32's rounding as the kernels compute it, on the int32
    view: half a TF32 unit added, the 13 dropped bits cleared."""
    return ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def test_codes_are_exact_in_tf32_and_bf16():
    c = CODES.to(torch.float32)
    assert torch.equal(_tf32_rna(c), c)
    assert torch.equal(c.to(torch.bfloat16).to(torch.float32), c)


def _split(route: str, Q: torch.Tensor) -> list[torch.Tensor]:
    """Q's pieces on ``route``, small first, each exact in its type."""
    if route == "tf32x2":
        hi = _tf32_rna(Q)
        return [_tf32_rna(Q - hi), hi]
    if route == "bf16x3":
        hi = Q.to(torch.bfloat16).to(torch.float32)
        mid = (Q - hi).to(torch.bfloat16).to(torch.float32)
        return [(Q - hi - mid).to(torch.bfloat16).to(torch.float32), mid, hi]
    return [_tf32_rna(Q)]                           # one unsplit product


@pytest.fixture(scope="module")
def gist_case():
    """Q f32[16, 960] normal, codes int8[256, 960] uniform, the exact q.c
    in float64, and the plain version's error (dequantize, f32 matmul)."""
    Q = torch.from_numpy(RNG.normal(size=(16, 960)).astype(np.float32))
    codes = torch.from_numpy(RNG.integers(-127, 128, (256, 960)).astype(
        np.int8))
    scale = torch.from_numpy((RNG.random(256) * 0.02 + 1e-3).astype(
        np.float32))
    exact = (Q.double() @ codes.double().T) * scale.double()
    plain = Q @ (codes.to(torch.float32) * scale[:, None]).T
    return Q, codes, scale, exact, float((plain.double() - exact).abs().max())


def _staged_dot(pieces, codes: torch.Tensor, stage: int = 32) -> torch.Tensor:
    """q.c as the tensor-core path sums it: each stage of ``stage`` columns
    into a fresh f32 partial, the pieces' exact products small first, the
    partial joined to an f32 total with a rounded add."""
    c = codes.double()
    total = torch.zeros((pieces[0].shape[0], codes.shape[0]))
    for k in range(0, codes.shape[1], stage):
        part = torch.zeros_like(total)
        for p in pieces:
            part = (part.double()
                    + p[:, k:k + stage].double() @ c[:, k:k + stage].T
                    ).to(torch.float32)
        total = total + part
    return total


@pytest.mark.parametrize("route,pieces,resid", [("tf32x2", 2, 2.0 ** -22),
                                                ("bf16x3", 3, 2.0 ** -24)])
def test_split_pieces_leave_an_f32_level_residual(gist_case, route, pieces,
                                                  resid):
    """The pieces sum back to q within ``resid`` of |q|: 2^-22 for two TF32
    pieces (11 significant bits each), 2^-24 for three BF16 pieces (8
    each); every piece is exact in its type."""
    Q = gist_case[0]
    parts = _split(route, Q)
    assert len(parts) == pieces
    back = sum(p.double() for p in parts)
    assert bool(((back - Q.double()).abs()
                 <= resid * Q.double().abs()).all())
    for p in parts:
        if route == "tf32x2":
            assert torch.equal(_tf32_rna(p), p)
        else:
            assert torch.equal(p.to(torch.bfloat16).to(torch.float32), p)


@pytest.mark.parametrize("route", ["tf32x2", "bf16x3"])
def test_split_route_holds_f32_accuracy_at_gist_width(gist_case, route):
    """Summed per 32-column stage as the kernel sums, the split's q.c at
    d = 960 stays within the card's criterion (4x the plain version's
    error against float64); one unsplit TF32 product misses it by far."""
    Q, codes, scale, exact, plain_err = gist_case
    dot = _staged_dot(_split(route, Q), codes) * scale
    err = float((dot.double() - exact).abs().max())
    assert err <= 4 * plain_err
    unsplit = _staged_dot(_split("tf32", Q), codes) * scale
    assert float((unsplit.double() - exact).abs().max()) > 100 * plain_err


# ---------------------------------------------------------------------------
# what the smoke run holds kernel 6 to
# ---------------------------------------------------------------------------


def test_smoke_run_builds_every_source_and_names_both_paths():
    """One nvcc for each source in csrc/, the two paths of kernel 6
    included; every kernel entry names a source that exists."""
    assert set(chip_smoke.SOURCES) == {p.stem for p in CSRC.glob("*.cu")}
    for name in ("quantized_distance_matrix",
                 "quantized_distance_matrix_wgmma"):
        source, replaces = chip_smoke.KERNELS[name]
        assert (chip_smoke.ROOT / source).is_file()
        assert replaces == "src/repro/kernels/quantized.py:61"
    assert set(chip_smoke.launch_counts()) == set(chip_smoke.KERNELS)


@pytest.mark.parametrize("shape,route,want_ms,by", [
    ((8, 1_000_000, 960), None, 0.2973, "bytes"),
    ((1024, 65_536, 960), None, 0.3928, "operations"),      # 3xBF16
    ((1024, 65_536, 960), "tf32x2", 0.5225, "operations"),
    ((1024, 65_536, 960), "bf16x3", 0.3928, "operations"),
])
def test_bound_is_the_cheapest_f32_accurate_route(shape, route, want_ms, by):
    """int8 codes: bytes at 3.35 TB/s or 3 BF16 products a product at 989
    TFLOP/s (2 TF32 products at 495 beside it), plus the l2 norms."""
    ms, got_by = chip_smoke._matrix_bound(*shape, 1, "l2", route=route)
    assert (round(ms, 4), got_by) == (want_ms, by)


def test_the_smoke_shapes_take_one_path_each_and_the_sweep_spans_both():
    scan, gist = chip_smoke.QUANT_SHAPES
    assert quantized.plan(_q(scan[0], scan[2]), _codes(3, scan[2]))[0] \
        == "stream"
    assert quantized.plan(_q(gist[0], gist[2]), _codes(3, gist[2]))[0] \
        == "wgmma"
    sweep = chip_smoke.QUANT_SWEEP_BATCHES
    assert T in sweep and min(b for b in sweep if b > T) <= 2 * T
    assert min(sweep) == 1 and max(sweep) >= 128


@pytest.mark.parametrize("metric", ["l2", "cos", "dot"])
def test_float64_reference_is_the_kernels_form(metric):
    """The float64 values the smoke run measures both paths against agree
    with the plain version to f32 rounding, and the plain version's own
    error is what the 4x criterion scales."""
    Q = torch.from_numpy(RNG.normal(size=(5, 960)).astype(np.float32))
    codes = torch.from_numpy(RNG.integers(-127, 128, (300, 960)).astype(
        np.int8))
    scale = torch.from_numpy((RNG.random(300) * 0.02 + 1e-3).astype(
        np.float32))
    scale[::7] = 0.0
    plain = ops.quantized_distance_matrix(Q, codes, scale, metric)
    got_err, plain_err = chip_smoke._f64_error(plain, plain, Q, codes,
                                               scale, metric)
    assert got_err == plain_err
    assert 0.0 < plain_err < 1e-3
