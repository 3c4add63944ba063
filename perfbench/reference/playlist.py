"""The plain reference of `Library.playlist_from([seed])` in NumPy at f64:
every other song of the library sorted by its euclidean distance to the
seed (stable on ties), the seed first, then bliss's dedup walk: a song is
dropped when it is closer than 0.05 to the last song kept or shares its
non-empty (title, artist) (src/library.rs:762-767, src/playlist.rs:367-402).

`judge` holds a served playlist to it. Two distances that lie closer than
the program's f32 rounding may come in either order, and the dedup walk
then sees other neighbours: an exact copy of a song that a third song's
near-tie separates from it stays, where f64 would drop it. So a playlist
is judged by what it says and not against one list: it must be in order
to within `tie` (`order_gap`); no two songs kept next to each other may be
the same; and each song it leaves out must be the same as a song it keeps
just before it, within `tie`.
"""

from __future__ import annotations

import numpy as np

THRESHOLD = 0.05


def distances(feats: np.ndarray, seed_row: int) -> np.ndarray:
    d = feats.astype(np.float64) - feats[seed_row].astype(np.float64)
    return np.sqrt((d * d).sum(1))


def playlist(feats: np.ndarray, titles, artists, seed_row: int) -> list:
    """The rows of the playlist, in order."""
    dist = distances(feats, seed_row)
    rest = np.delete(np.arange(len(feats)), seed_row)
    order = np.concatenate([[seed_row], rest[np.argsort(dist[rest], kind="stable")]])
    x = feats.astype(np.float64)
    step = x[order[1:]] - x[order[:-1]]
    consecutive = np.sqrt((step * step).sum(1))
    kept = [int(order[0])]
    for i, row in enumerate(order[1:].tolist()):
        cur = kept[-1]
        if cur == order[i]:
            pair = consecutive[i]
        else:
            d = x[row] - x[cur]
            pair = float(np.sqrt(d @ d))
        if pair < THRESHOLD:
            continue
        if titles[row] == titles[cur] and artists[row] == artists[cur]:
            continue
        kept.append(row)
    return kept


def order_gap(feats: np.ndarray, seed_row: int, rows) -> float:
    """The widest step by which the playlist `rows` goes back down in the
    f64 distance to the seed: max over i of (max of d[rows[:i]]) - d[rows[i]];
    0 for a playlist in order."""
    d = distances(feats, seed_row)[np.asarray(rows, np.int64)]
    return float(np.max(np.maximum.accumulate(d) - d)) if len(d) else 0.0


def same(feats, titles, artists, a: int, b: int) -> bool:
    """The dedup's verdict on two rows, at f64."""
    d = feats[a].astype(np.float64) - feats[b].astype(np.float64)
    if float(np.sqrt(d @ d)) < THRESHOLD:
        return True
    return titles[a] == titles[b] and artists[a] == artists[b]


def judge(feats: np.ndarray, titles, artists, seed_row: int, rows, tie: float):
    """`(errors, order_gap)` of a served playlist `rows`: errors counts a
    seed not first, a row served twice or out of range, two neighbours
    the dedup should have merged, and each row left out that no kept song
    at or just before its place is the same as."""
    rows = np.asarray(rows, np.int64)
    n = len(feats)
    errors = int(len(rows) == 0 or rows[0] != seed_row)
    errors += int(((rows < 0) | (rows >= n)).sum())
    rows = rows[(rows >= 0) & (rows < n)]
    errors += len(rows) - len(np.unique(rows))
    errors += sum(same(feats, titles, artists, int(a), int(b)) for a, b in zip(rows[:-1], rows[1:]))
    d = distances(feats, seed_row)
    reach = np.maximum.accumulate(d[rows])  # the farthest distance served so far
    missing = np.setdiff1d(np.arange(n), rows)
    for r in missing.tolist():
        lo = max(int(np.searchsorted(reach, d[r] - tie)) - 1, 0)
        hi = int(np.searchsorted(reach, d[r] + tie, side="right"))
        if not any(same(feats, titles, artists, int(k), r) for k in rows[lo:hi]):
            errors += 1
    return errors, order_gap(feats, seed_row, rows)
