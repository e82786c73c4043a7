"""Exact dynamic time warping over a distance matrix, as an anti-diagonal
wavefront in numpy.

The JAX package's MCD aligns with its C++ ``tdvc_dtw_path``
(``td_vc_gan_tpu/native/src/audio_kernels.cpp:42-90``); its Python-loop
fallback is far too slow for 4.5 s utterances (~800 x 800 cells). Every cell
of an anti-diagonal ``i + j = k`` depends only on the two diagonals before
it, so each diagonal is one vector step. In the padded (n+1, m+1)
accumulator, flattened, a diagonal's cells lie ``m`` apart, and so do their
up, left and diagonal neighbours: every operand is a strided view.

The arithmetic is the C++ one, so cost and path are identical:

- the distances are rounded to float32, the sums are float64, ``d + best``
  per cell, ``acc[0, 0] = d[0, 0]``;
- ties pick the diagonal, then up (``i-1``), then left (``j-1``), a later
  option only when it is strictly less;
- the moves are stored, and the backtrack follows them from (n-1, m-1) to
  (0, 0), leaving the first row by the left and the first column by up.
"""

from __future__ import annotations

import numpy as np

DIAG, UP, LEFT = 0, 1, 2


def dtw(dist: np.ndarray) -> tuple[float, np.ndarray]:
    """Full DTW over ``dist`` (n, m) -> (total cost, path (L, 2) int32 of
    (i, j) from (0, 0) to (n-1, m-1))."""
    dist = np.asarray(dist)
    n, m = dist.shape
    if n == 0 or m == 0:
        raise ValueError(f"DTW needs a non-empty distance matrix, got {dist.shape}")
    w = m + 1
    acc = np.full((n + 1) * w, np.inf)  # acc[i+1, j+1], row and column 0 at inf
    d = np.zeros((n + 1) * w)
    d.reshape(n + 1, w)[1:, 1:] = dist.astype(np.float32)
    moves = np.zeros((n + 1) * w, dtype=np.int8)
    for k in range(n + m - 1):
        lo, hi = max(0, k - m + 1), min(k, n - 1)
        # cell (i, k-i) sits at (i+1)*w + k-i+1 = i*m + w + k + 1
        first = lo * m + w + k + 1
        at = slice(first, hi * m + w + k + 2, m)
        diag, up, left = (acc[first - off:at.stop - off:m] for off in (w + 1, w, 1))
        take_up = up < diag
        best = np.where(take_up, up, diag)
        take_left = left < best
        best = np.where(take_left, left, best)
        if k == 0:
            best[:] = 0.0
        acc[at] = d[at] + best
        moves[at] = np.where(take_left, LEFT, np.where(take_up, UP, DIAG))
    moves = moves.reshape(n + 1, w)
    path = []
    i, j = n - 1, m - 1
    while True:
        path.append((i, j))
        if i == 0 and j == 0:
            break
        mv = moves[i + 1, j + 1]
        if mv == DIAG and i > 0 and j > 0:
            i, j = i - 1, j - 1
        elif mv == UP and i > 0:
            i -= 1
        elif j > 0:
            j -= 1
        else:
            i -= 1
    return float(acc[n * w + m]), np.asarray(path[::-1], dtype=np.int32).reshape(-1, 2)
