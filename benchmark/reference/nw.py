"""Needleman-Wunsch by minimum penalty, with the reference program's traceback.

The DP of ``seqalign-mpi-skeleton.cpp:186-235``: D[i][0] = i * pgap,
D[0][j] = j * pgap, D[i][j] = min(D[i-1][j-1] + (x[i-1] == y[j-1] ? 0 : pxy),
D[i-1][j] + pgap, D[i][j-1] + pgap). Its traceback (:236-262) walks back from
(m, n) and takes, in this order, the diagonal when the cell came from it (on
a match it always does), else up, else left.

A batch of pairs is swept a row at a time in plain torch ops, every pair of
the batch in the same ops, padded to the batch's largest m and n (the padding
lies below and right of each pair's cells and never reaches them). The
sweep holds F[i][j] = D[i][j] - (i + j) * pgap, in which up and left cost
nothing and the diagonal costs (x[i-1] == y[j-1] ? 0 : pxy) - 2 * pgap:
F[i][j] = prefix minimum over c <= j of T[c], T[c] = min(F[i-1][c-1] + cost,
F[i-1][c]), with F[i][0] = F[0][j] = 0. The prefix minimum runs in chunks of
``SCAN`` columns, then across the chunks. Each cell keeps two bits: whether
it did not come from the diagonal, and whether it did not come from up (or,
with ``left_first``, a broken rule kept as the control, from the left). The
rows go in blocks of ``ROWS``; on a card each block's steps are one CUDA
graph of the same ops. The bits of the whole DP are packed eight a byte on
the card, copied to the host and walked from (m, n) back to a border.

Nothing here is the program's: the store is the full (m, n) matrix of
moves, where the program keeps snapshots and recomputes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from reference.alignment import DIAG, LEFT, UP, strings

SCAN = 256  # columns a prefix-minimum chunk holds
ROWS = 64  # rows a block holds: their costs gathered, their steps one CUDA graph, their bits packed
BIG = 1 << 30  # above any F value
BITS = (1, 2, 4, 8, 16, 32, 64, 128)


def store_bytes(m: int, n: int, count: int) -> int:
    """Device bytes of a batch of ``count`` pairs padded to m x n."""
    cols = -(-(n + 1) // SCAN) * SCAN
    rows = -(-m // ROWS) * ROWS
    return count * (2 * rows * -(-n // 8) + ROWS * (4 * n + 3 * n) + 8 * 4 * cols)


def default_budget(device: torch.device) -> int:
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return int(free * 0.6)
    return 1 << 30


def align(pairs: Sequence[Tuple[str, str]], pxy: int, pgap: int, device: torch.device,
          left_first: bool = False, budget: Optional[int] = None) -> List[Tuple[int, str, str]]:
    """(penalty, align1, align2) of each (x, y), in order; x gives the rows."""
    budget = budget or default_budget(device)
    order = sorted(range(len(pairs)), key=lambda p: (-len(pairs[p][0]), -len(pairs[p][1])))
    out: List[Optional[Tuple[int, str, str]]] = [None] * len(pairs)
    start = 0
    while start < len(order):
        end = start + 1
        m, n = len(pairs[order[start]][0]), len(pairs[order[start]][1])
        if store_bytes(m, n, 1) > budget:
            raise MemoryError(f"a {m} x {n} pair needs {store_bytes(m, n, 1)} bytes,"
                              f" over the reference's budget of {budget}")
        while end < len(order):
            n_end = max(n, len(pairs[order[end]][1]))
            if store_bytes(m, n_end, end + 1 - start) > budget:
                break
            n = n_end
            end += 1
        batch = [pairs[p] for p in order[start:end]]
        for p, res in zip(order[start:end], _align_batch(batch, pxy, pgap, device, left_first)):
            out[p] = res
        start = end
    return out  # type: ignore[return-value]


def _codes(seqs: Sequence[str], width: int) -> np.ndarray:
    out = np.zeros((len(seqs), width), np.uint8)
    for b, s in enumerate(seqs):
        out[b, : len(s)] = np.frombuffer(s.encode("latin-1"), np.uint8)
    return out


def _align_batch(batch, pxy, pgap, device, left_first):
    xs, ys = [p[0] for p in batch], [p[1] for p in batch]
    B = len(batch)
    ms, ns = [len(x) for x in xs], [len(y) for y in ys]
    if min(ms) == 0 or min(ns) == 0:
        raise ValueError("every sequence must hold at least one character")
    M, N = -(-max(ms) // ROWS) * ROWS, max(ns)  # rows past a pair's m are never read
    N8 = -(-N // 8)
    C = -(-(N + 1) // SCAN)
    W = C * SCAN
    xc, yc = _codes(xs, M), _codes(ys, N)
    # Diagonal cost rows: one per (pair, symbol of x); row i of pair b is
    # table[rowsel[i * B + b]].
    alphabet = np.unique(xc)
    sym = np.searchsorted(alphabet, xc)  # (B, M)
    cost = np.where(yc[:, None, :] == alphabet[None, :, None], 0, pxy) - 2 * pgap
    table = torch.from_numpy(cost.astype(np.int32).reshape(B * len(alphabet), N)).to(device)
    rowsel = torch.from_numpy(
        (np.arange(B)[:, None] * len(alphabet) + sym).T.reshape(-1).astype(np.int64)).to(device)

    i32 = dict(dtype=torch.int32, device=device)
    f = [torch.zeros((B, W), **i32), torch.zeros((B, W), **i32)]  # rows i - 1 and i, in turn
    diag = torch.full((B, W), BIG, **i32)  # column 0 has no diagonal; past N, padding
    t = torch.empty((B, W), **i32)
    idx = torch.empty((B, C, SCAN), dtype=torch.int64, device=device)
    cidx = torch.empty((B, C), dtype=torch.int64, device=device)
    carry = torch.empty((B, C), **i32)
    costs = torch.empty((ROWS, B, N), **i32)
    bits = torch.zeros((2, ROWS, B, 8 * N8), dtype=torch.bool, device=device)
    ends = torch.tensor([b * W + n for b, n in enumerate(ns)], dtype=torch.int64, device=device)
    f_ends = torch.empty((ROWS, B), **i32)  # F[i][n_b] of each row of the block
    weights = torch.tensor(BITS, dtype=torch.uint8, device=device)
    store = torch.empty((2, M, B, N8), dtype=torch.uint8, device=device)

    def step(r: int) -> None:
        prev, cur = f[r % 2], f[(r + 1) % 2]
        torch.add(prev[:, :N], costs[r], out=diag[:, 1 : N + 1])
        torch.minimum(diag, prev, out=t)
        cur3 = cur.view(B, C, SCAN)
        torch.cummin(t.view(B, C, SCAN), 2, out=(cur3, idx))
        torch.cummin(cur3[:, :, -1], 1, out=(carry, cidx))
        torch.minimum(cur3[:, 1:], carry[:, :-1, None], out=cur3[:, 1:])
        here = cur[:, 1 : N + 1]
        torch.ne(here, diag[:, 1 : N + 1], out=bits[0, r, :, :N])
        torch.ne(here, cur[:, :N] if left_first else prev[:, 1 : N + 1], out=bits[1, r, :, :N])
        torch.index_select(cur.view(-1), 0, ends, out=f_ends[r])

    def block() -> None:  # ROWS is even: the block ends with its last row in f[0]
        for r in range(ROWS):
            step(r)

    def gather(i0: int) -> None:
        torch.index_select(table, 0, rowsel[i0 * B : (i0 + ROWS) * B],
                           out=costs.view(ROWS * B, N))

    run_block = block
    if device.type == "cuda":
        # Warm up on a side stream, start again from row 0, then capture the
        # block's steps once: a replay launches them without the host.
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            gather(0)
            block()
        torch.cuda.current_stream(device).wait_stream(side)
        for buf in f:
            buf.zero_()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            block()
        run_block = graph.replay

    f_end = [None] * B
    for i0 in range(0, M, ROWS):  # rows i0 + 1 .. i0 + ROWS
        gather(i0)
        run_block()
        packed = bits.view(2, ROWS, B, N8, 8).to(torch.uint8).mul_(weights)
        store[:, i0 : i0 + ROWS] = packed.sum(-1, dtype=torch.uint8)
        for b, m in enumerate(ms):
            if i0 < m <= i0 + ROWS:
                f_end[b] = f_ends[m - i0 - 1, b].clone()

    penalties = [int(v) + (m + n) * pgap for v, m, n in zip(f_end, ms, ns)]
    planes = store.cpu().numpy()
    del store, bits, costs
    not_diag, not_second = (memoryview(planes[k].reshape(-1)) for k in (0, 1))
    second, third = (LEFT, UP) if left_first else (UP, LEFT)
    out = []
    for b in range(B):
        moves = _walk(not_diag, not_second, B * N8, b * N8, ms[b], ns[b], second, third)
        _check_cost(xs[b], ys[b], moves, pxy, pgap, penalties[b])
        out.append((penalties[b], *strings(xs[b], ys[b], moves)))
    return out


def _walk(not_diag: memoryview, not_second: memoryview, row_stride: int, base: int,
          m: int, n: int, second: int, third: int) -> bytearray:
    """The moves from (m, n) back to a border, read from the two bit planes."""
    moves = bytearray()
    i, j = m, n
    while i and j:
        c = j - 1
        k = (i - 1) * row_stride + base + (c >> 3)
        bit = 1 << (c & 7)
        d = DIAG if not not_diag[k] & bit else (second if not not_second[k] & bit else third)
        moves.append(d)
        if d == DIAG:
            i -= 1
            j -= 1
        elif d == UP:
            i -= 1
        else:
            j -= 1
    return moves


def _check_cost(x: str, y: str, moves: bytearray, pxy: int, pgap: int, penalty: int) -> None:
    """Raise unless the walk's own cost is the penalty (a fault of the reference)."""
    mv = np.frombuffer(bytes(moves), np.uint8)[::-1]
    takes_x, takes_y = mv != LEFT, mv != UP
    i0, j0 = len(x) - int(takes_x.sum()), len(y) - int(takes_y.sum())
    xi = i0 + np.cumsum(takes_x) - 1
    yj = j0 + np.cumsum(takes_y) - 1
    d = mv == DIAG
    xb = np.frombuffer(x.encode("latin-1"), np.uint8)
    yb = np.frombuffer(y.encode("latin-1"), np.uint8)
    subs = int((xb[xi[d]] != yb[yj[d]]).sum())
    walked = subs * pxy + int((~d).sum()) * pgap + (i0 + j0) * pgap
    if walked != penalty:
        raise AssertionError(f"reference: the walk costs {walked}, the DP says {penalty}")
