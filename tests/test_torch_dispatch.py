"""Dispatch goes by the tensor's device and never hides the card.

A CPU tensor runs the plain version and launches nothing; a CUDA request
on a host without CUDA raises instead of falling back to the CPU; the
kernel's loader raises a clear error when ``nvcc`` is absent.
"""

import numpy as np
import pytest
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core.graph import FIELDS, graph_from_numpy
from repro_torch.core.navix import NavixConfig, NavixIndex
from repro_torch.core.quantize import quantize
from repro_torch.kernels import (_build, distance_matrix, gather_distance,
                                 ops, quantized, quantized_gather_distance,
                                 ref, segment_sum)

RNG = np.random.default_rng(0)


def _inputs(b=3, n=20, d=8, k=5):
    Q = torch.from_numpy(RNG.normal(size=(b, d)).astype(np.float32))
    X = torch.from_numpy(RNG.normal(size=(n, d)).astype(np.float32))
    ids = torch.from_numpy(RNG.integers(-1, n, size=(b, k)).astype(np.int32))
    return Q, X, ids


@pytest.fixture
def no_cuda(monkeypatch):
    """A host on which torch reports no CUDA device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("metric", ["l2", "cos", "dot"])
def test_cpu_tensor_runs_plain_version_and_launches_nothing(metric):
    Q, X, ids = _inputs()
    before = gather_distance.LAUNCHES, dict(gather_distance.PATH_LAUNCHES)
    got = ops.gather_distance_batch(Q, X, ids, metric)
    assert (gather_distance.LAUNCHES, gather_distance.PATH_LAUNCHES) \
        == before
    assert torch.equal(got, ref.gather_distance_batch(Q, X, ids, metric))


@pytest.mark.parametrize("metric", ["l2", "cos", "dot"])
def test_cpu_store_runs_plain_version_and_launches_nothing(metric):
    Q, X, ids = _inputs()
    store = quantize(X)
    def counts():
        return (quantized_gather_distance.LAUNCHES,
                quantized_gather_distance.ONE_LANE_LAUNCHES,
                dict(quantized_gather_distance.PATH_LAUNCHES),
                gather_distance.LAUNCHES, gather_distance.ONE_LANE_LAUNCHES,
                dict(gather_distance.PATH_LAUNCHES))
    before = counts()
    got = ops.quantized_gather_distance_batch(Q, store.codes, store.scale,
                                              ids, metric)
    one = ops.quantized_gather_distance(Q[1], store.codes, store.scale,
                                        ids[1], metric)
    f32_one = ops.gather_distance(Q[1], X, ids[1], metric)
    assert counts() == before
    assert torch.equal(got, ref.quantized_gather_distance_batch(
        Q, store.codes, store.scale, ids, metric))
    assert torch.equal(one, got[1])
    assert torch.equal(f32_one, ref.gather_distance(Q[1], X, ids[1], metric))


def _matrix_inputs():
    Q, X, _ = _inputs()
    store = quantize(X)
    dst = torch.from_numpy(np.sort(RNG.integers(0, 6, size=20)).astype(
        np.int32))
    dst[-3:] = -1                               # padding sorts last
    return Q, X, store, X.clone(), dst


@pytest.mark.parametrize("metric", ["l2", "cos", "dot"])
def test_cpu_matrix_entries_run_plain_versions_and_launch_nothing(metric):
    Q, X, store, msgs, dst = _matrix_inputs()
    counts = (distance_matrix.LAUNCHES, quantized.LAUNCHES,
              segment_sum.LAUNCHES)
    got = ops.distance_matrix(Q, X, metric)
    got_q = ops.quantized_distance_matrix(Q, store.codes, store.scale, metric)
    got_s = ops.csr_segment_sum(msgs, dst, 6)
    assert counts == (distance_matrix.LAUNCHES, quantized.LAUNCHES,
                      segment_sum.LAUNCHES)
    assert torch.equal(got, ref.distance_matrix(Q, X, metric))
    assert torch.equal(got_q, ref.quantized_distance_matrix(
        Q, store.codes, store.scale, metric))
    assert torch.equal(got_s, ref.csr_segment_sum(msgs, dst, 6))


def test_matrix_entries_raise_on_mixed_devices():
    Q, X, store, msgs, dst = _matrix_inputs()
    with pytest.raises(ValueError, match="different devices"):
        ops.distance_matrix(Q.to("meta"), X)
    with pytest.raises(ValueError, match="different devices"):
        ops.quantized_distance_matrix(Q, store.codes,
                                      store.scale.to("meta"))
    with pytest.raises(ValueError, match="different devices"):
        ops.csr_segment_sum(msgs, dst.to("meta"), 6)
    with pytest.raises(ValueError, match="no distance_matrix path"):
        ops.distance_matrix(Q.to("meta"), X.to("meta"))


def test_matrix_wrappers_refuse_cpu_tensors():
    Q, X, store, msgs, dst = _matrix_inputs()
    with pytest.raises(ValueError, match="CUDA tensors only"):
        distance_matrix.distance_matrix(Q, X, "dot")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        quantized.quantized_distance_matrix(Q, store.codes, store.scale, "l2")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        segment_sum.csr_segment_sum(msgs, dst, 6)


def test_mixed_devices_raise():
    Q, X, ids = _inputs()
    with pytest.raises(ValueError, match="different devices"):
        ops.gather_distance_batch(Q.to("meta"), X, ids)
    with pytest.raises(ValueError, match="different devices"):
        ops.gather_distance(Q[0], X.to("meta"), ids[0])
    store = quantize(X)
    with pytest.raises(ValueError, match="different devices"):
        ops.quantized_gather_distance_batch(Q, store.codes,
                                            store.scale.to("meta"), ids)
    with pytest.raises(ValueError, match="different devices"):
        ops.quantized_gather_distance(Q[0], store.codes.to("meta"),
                                      store.scale, ids[0])


def test_unsupported_device_raises():
    Q, X, ids = _inputs()
    with pytest.raises(ValueError, match="no gather_distance_batch path"):
        ops.gather_distance_batch(Q.to("meta"), X.to("meta"), ids.to("meta"))


def test_cuda_wrapper_refuses_cpu_tensors():
    Q, X, ids = _inputs()
    with pytest.raises(ValueError, match="CUDA tensors only"):
        gather_distance.gather_distance_batch(Q, X, ids, "l2")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        gather_distance.gather_distance(Q[0], X, ids[0], "l2")
    store = quantize(X)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        quantized_gather_distance.quantized_gather_distance_batch(
            Q, store.codes, store.scale, ids, "l2")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        quantized_gather_distance.quantized_gather_distance(
            Q[0], store.codes, store.scale, ids[0], "l2")


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.float32])
def test_int8_wrapper_refuses_codes_of_another_type(dtype):
    Q, X, ids = _inputs()
    store = quantize(X)
    with pytest.raises(TypeError, match="codes must be int8"):
        quantized_gather_distance.quantized_gather_distance_batch(
            Q, store.codes.to(dtype), store.scale, ids, "l2")


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_cuda_default_raises_without_cuda(no_cuda):
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(dev)


def test_entry_points_do_not_fall_back_to_cpu(no_cuda):
    X = RNG.normal(size=(40, 8)).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NavixIndex.create(X, NavixConfig(m_u=4, ef_construction=16))
    arrays = {"lower": np.full((40, 8), -1), "lower_deg": np.zeros(40),
              "upper": np.full((2, 4), -1), "upper_deg": np.zeros(2),
              "upper_ids": np.arange(2), "entry_pos": np.int32(0),
              "vectors": X}
    assert set(arrays) == set(FIELDS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graph_from_numpy(arrays)
    g = graph_from_numpy(arrays, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NavixIndex.from_graph(g, NavixConfig())
    idx = NavixIndex.from_graph(g, NavixConfig(), device="cpu")
    assert idx.device == torch.device("cpu")


def test_loader_raises_clearly_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("gather_distance")


def test_launch_errors_carry_the_cuda_message(monkeypatch):
    _build.check_launch("distance_matrix", 0)

    def error_string(code):
        return b"invalid argument" if code == 1 else b"?"
    lib = type("Lib", (), {"navix_cuda_error_string": error_string})
    monkeypatch.setattr(_build, "load", lambda name: {"cuda_error": lib}[name])
    with pytest.raises(RuntimeError, match=r"segment_sum kernel launch "
                       r"failed: invalid argument \(cudaError 1\)"):
        _build.check_launch("csr_segment_sum", 1)


def test_input_check_names_the_tensor_off_the_card():
    Q, X, ids = _inputs()
    with pytest.raises(ValueError, match="ids lies on cpu; the CUDA kernel "
                       "takes CUDA tensors only"):
        _build.check_cuda_inputs("gather_distance_batch", ids=ids)
    with pytest.raises(ValueError, match="X lies on meta"):
        _build.check_cuda_inputs("distance_matrix", X=X.to("meta"))
