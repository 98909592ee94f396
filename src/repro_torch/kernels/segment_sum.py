"""Wrapper of the CUDA CSR segment sum (``csrc/segment_sum.cu``).

Replaces the TPU kernel ``repro/kernels/segment_sum.py::
csr_segment_sum_pallas``; the source note in the ``.cu`` file gives the
kernel's bound and design. The plain PyTorch version is
``kernels/ref.py::csr_segment_sum``; :func:`span_schedule` is the kernel's
own schedule in plain PyTorch (the same spans, rows read, stores and sums in
the same order), which the tests hold the kernel to bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: padding destination id: sorts after every real node id (callers replace
#: -1 with it before sorting)
PAD_SENTINEL = 0x3FFFFFFF

#: bytes of message rows a span holds (one warp streams one span) ...
SPAN_BYTES = 128 * 1024
#: ... and its most rows (``kMaxSpanRows`` in the source)
MAX_SPAN_ROWS = 512
#: rows a short segment may run past the end of the span it starts in
#: (``kLook``; at most the span's rows)
LOOK_ROWS = 32

#: kernel launches made by :func:`csr_segment_sum` in this process: the span
#: kernel, and the fix-up kernel when the call has more than one span
LAUNCHES = 0


def _kernel():
    return _build.bind("segment_sum", "navix_csr_segment_sum",
                       [ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 4)


def plan(e: int, d: int) -> tuple[int, int]:
    """(span_rows, n_spans) of a call over E = ``e`` rows of width ``d``:
    spans of ``SPAN_BYTES`` of rows (1 to ``MAX_SPAN_ROWS`` rows), at least
    one span."""
    rows = min(MAX_SPAN_ROWS, max(1, SPAN_BYTES // (4 * d)))
    return rows, max(1, -(-e // rows))


def launches(e: int, d: int) -> int:
    """Kernel launches of one call over ``e`` rows of width ``d``."""
    return 1 if plan(e, d)[1] == 1 else 2


def csr_segment_sum(messages: torch.Tensor, dst_sorted: torch.Tensor,
                    n: int) -> torch.Tensor:
    """f32[n, d]: out[v] = sum of messages[e] with dst_sorted[e] == v, on the
    CUDA device.

    messages f32[E, d] and dst_sorted int32[E] (ascending; destinations
    outside [0, n), such as ``PAD_SENTINEL`` padding, are dropped),
    contiguous and on one CUDA device. Launches on the current stream and
    raises if a launch fails.
    """
    _build.check_cuda_inputs("csr_segment_sum", messages=messages,
                             dst_sorted=dst_sorted)
    if messages.dtype != torch.float32:
        raise TypeError(f"messages must be float32, got {messages.dtype}")
    if dst_sorted.dtype != torch.int32:
        raise TypeError(f"dst_sorted must be int32, got {dst_sorted.dtype}")
    if messages.ndim != 2 or dst_sorted.shape != (messages.shape[0],):
        raise ValueError(f"expected messages[E, d] and dst_sorted[E], got "
                         f"{tuple(messages.shape)} and "
                         f"{tuple(dst_sorted.shape)}")
    d = messages.shape[1]
    if not 0 <= n < PAD_SENTINEL or d > _build.INT32_MAX:
        raise ValueError(f"n = {n} or d = {d} is outside the kernel's range")
    return _launch(messages, dst_sorted, n, plan(messages.shape[0], d)[0])


def _launch(messages: torch.Tensor, dst_sorted: torch.Tensor, n: int,
            span_rows: int) -> torch.Tensor:
    """The kernel at ``span_rows`` rows a span (checked inputs)."""
    global LAUNCHES
    e, d = messages.shape
    out = torch.empty((n, d), dtype=torch.float32, device=messages.device)
    if n == 0 or d == 0:
        return out
    n_spans = max(1, -(-e // span_rows))
    if n_spans > _build.INT32_MAX:
        raise ValueError(f"{n_spans} spans is outside the kernel's range")
    carry = torch.empty((n_spans, 2, d), dtype=torch.float32,
                        device=messages.device)
    flags = torch.empty((n_spans,), dtype=torch.int32, device=messages.device)
    _build.launch("csr_segment_sum", _kernel(), messages.device,
                  messages.data_ptr(), dst_sorted.data_ptr(), out.data_ptr(),
                  carry.data_ptr(), flags.data_ptr(), e, n, d, span_rows,
                  n_spans)
    LAUNCHES += 1 if n_spans == 1 else 2
    return out


def span_schedule(messages: torch.Tensor, dst_sorted: torch.Tensor, n: int,
                  span_rows: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out f32[n, d], reads int64[E], writes int64[n]): the kernel's
    schedule in plain PyTorch, span by span and row by row (for small
    inputs), so on the same inputs ``out`` equals the kernel's bit for bit.
    ``reads[e]`` counts the spans that load message row e (the rows
    ``need_lo`` .. ``need_hi`` - 1 of each span's stream) and ``writes[v]``
    the stores to out row v (sums and zero fills); rows never stored stay
    NaN, as ``torch.empty`` would leave them garbage.

    Span t holds rows t*S .. t*S + S - 1 (S = ``span_rows``). It decides
    from the destinations of its rows, of the L = min(``LOOK_ROWS``, S) rows
    after it and of the rows s0 - 1, s0 - S - 1, s0 + L, s1 and s1 + L, as
    the kernel does: a segment (the rows of one destination in [0, n))
    that ends at most L rows past the end of the span it starts in is
    summed there whole, in edge order from zero, and skipped by the span
    after; a longer one is summed per span in edge order from zero into
    carry slots, then (the fix-up) those pieces in span order from zero.
    The span holding a boundary between destinations u < w fills u + 1 ..
    w - 1 with zeros, span 0 also from 0 and the last span also up to n - 1.
    """
    m = messages.detach().to("cpu", torch.float32)
    e, d = m.shape
    S, look = span_rows, min(LOOK_ROWS, span_rows)
    n_spans = max(1, -(-e // S))
    ids = [-1 if x < 0 else min(x, n)
           for x in dst_sorted.detach().to("cpu", torch.int64).tolist()]
    out = torch.full((n, d), float("nan"))
    carry = torch.full((n_spans, 2, d), float("nan"))
    reads = torch.zeros(e, dtype=torch.int64)
    writes = torch.zeros(n, dtype=torch.int64)
    flags = [False] * n_spans

    def dest(r):
        return ids[r]

    def valid(v):
        return 0 <= v < n

    def fill(a, b):                       # zeros to rows a + 1 .. b - 1
        if a + 1 < b:
            out[a + 1:b] = 0.0
            writes[a + 1:b] += 1

    def store(t, to, acc):                # to: a node, "slot0", "slot1"
        if to in ("slot0", "slot1"):
            carry[t, int(to == "slot1")] = acc
        elif to is not None:
            out[to] = acc
            writes[to] += 1

    for t in range(n_spans):
        s0 = t * S
        s1 = min(s0 + S, e)
        wend = min(s1 + look, e)
        v0 = dest(s0) if s0 < e else n
        before = dest(s0 - 1) if s0 > 0 else -1
        head_old = s0 > S and dest(s0 - S - 1) == v0
        head_far = s0 + look < e and dest(s0 + look) == v0
        vt = dest(s1 - 1) if s1 > 0 else -1
        after = s1 < e and dest(s1) == vt
        tail_far = s1 + look < e and dest(s1 + look) == vt
        head_cont = s0 < s1 and s0 > 0 and valid(v0) and before == v0
        head_through = head_cont and vt == v0 and after
        head_long = head_cont and (head_old or head_far)
        skip = v0 if head_cont and not head_long else -2
        tail_cross = valid(vt) and after and not head_through
        tail_long = tail_cross and tail_far
        flags[t] = head_long and not head_through
        end = s1
        if tail_cross and not tail_long:
            end = next((r for r in range(s1, wend) if dest(r) != vt), wend)
        need = [r for r in range(s0, end)
                if valid(dest(r)) and dest(r) != skip]
        if need:
            reads[need[0]:need[-1] + 1] += 1
        if s0 < s1:
            if before != v0:
                fill(before, v0)
            cur, first, acc = v0, True, torch.zeros(d)
            for r in range(s0, end):
                v = dest(r)
                if v != cur:              # a boundary inside the span
                    store(t, "slot0" if first and head_long else
                             None if first and skip == cur else
                             cur if valid(cur) else None, acc)
                    fill(cur, v)
                    first, cur, acc = False, v, torch.zeros(d)
                if valid(v) and v != skip:
                    acc = acc + m[r]
            store(t, "slot0" if first and head_long else
                  None if first and skip == cur else
                  "slot1" if tail_long else
                  cur if valid(cur) else None, acc)
        if t == n_spans - 1:              # the nodes after the last edge
            fill(dest(e - 1) if e > 0 else -1, n)
    # the fix-up: a long segment ending in flagged span t starts in the last
    # span s_a <= t whose row before it holds another destination (or 0)
    for t in range(n_spans):
        if flags[t]:
            v, sa = dest(t * S), t
            while sa > 0 and dest(sa * S - 1) == v:
                sa -= 1
            acc = torch.zeros(d) + carry[sa, 1]
            for u in range(sa + 1, t + 1):
                acc = acc + carry[u, 0]
            out[v] = acc
            writes[v] += 1
    return out, reads, writes
