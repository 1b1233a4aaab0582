"""The plain reference: every hit of every read, from the text and the
reads alone, in plain PyTorch (on the card or the CPU).

The hit contract it implements: a row (query, seqId, pos, errors) for
every text position ``p`` (``pos`` within record ``seqId``) where the query
aligns to a span that starts at ``p`` with at most ``k`` edits, ``errors``
being the least such count.  The span's first char is aligned to a query
char (matched or substituted), not deleted: a span that starts by
deleting text chars is the hit of a later position.  Leading and trailing
query chars may be inserted.  Chars outside a record (its separator, or
outside the text) can be neither matched, substituted nor deleted.

The search is by pigeonhole: of the k+1 balanced parts of a query, an
alignment with at most k edits matches one exactly, so the first ``g``
chars of that part occur in the text within k of where the alignment puts
them.  The reference looks every part's ``g``-mer up in a sorted table of
the text's ``g``-mers, widens each occurrence to the 2k+1 starts it
allows, and scores each (query, start) by a banded dynamic programme.
"""

from __future__ import annotations

import numpy as np
import torch

INF = 1 << 20
MAX_G = 31  # 2 bits a char in an int64 key


def parts_of(m: int, k: int) -> list[tuple[int, int]]:
    """The k+1 balanced parts (offset, length) of an m-char query."""
    base, rem = divmod(m, k + 1)
    out, off = [], 0
    for i in range(k + 1):
        ln = base + (i < rem)
        out.append((off, ln))
        off += ln
    return out


class Text:
    """The records on one device: concatenated, each followed by a 0
    separator, and the sorted table of their ``g``-mers."""

    def __init__(self, records: list[np.ndarray], g: int, device):
        if not 1 <= g <= MAX_G:
            raise ValueError(f"g-mer length {g} outside 1..{MAX_G}")
        lens = np.array([len(r) for r in records], dtype=np.int64)
        self.starts = np.concatenate([[0], np.cumsum(lens + 1)[:-1]]).astype(np.int64)
        flat = np.zeros(int((lens + 1).sum()), dtype=np.uint8)
        for s, r in zip(self.starts, records):
            flat[s : s + len(r)] = r
        self.device = torch.device(device)
        self.g = g
        self.chars = torch.from_numpy(flat).to(self.device)
        n = len(flat)
        if n < g:
            self.keys = torch.zeros(0, dtype=torch.int64, device=self.device)
            self.at = torch.zeros(0, dtype=torch.int64, device=self.device)
            return
        code = torch.zeros(n - g + 1, dtype=torch.int64, device=self.device)
        valid = torch.ones(n - g + 1, dtype=torch.bool, device=self.device)
        for j in range(g):
            c = self.chars[j : n - g + 1 + j].long()
            valid &= (c >= 1) & (c <= 4)
            code = code * 4 + (c - 1).clamp(0, 3)
        at = torch.nonzero(valid).squeeze(1)
        self.keys, order = torch.sort(code[at])
        self.at = at[order]

    @property
    def n(self) -> int:
        return self.chars.shape[0]

    def window(self, start: torch.Tensor, width: int) -> torch.Tensor:
        """uint8[L, width]: chars at ``start[l] + x``, 0 outside the text."""
        pos = start[:, None] + torch.arange(width, device=self.device)
        inside = (pos >= 0) & (pos < self.n)
        return torch.where(inside, self.chars[pos.clamp(0, self.n - 1)], 0)


def candidates(text: Text, queries: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Distinct (query, start) pairs, int64 each, that pigeonhole admits."""
    nq, m = queries.shape
    q_all, p_all = [], []
    for off, ln in parts_of(m, k):
        g = text.g
        if ln < g:
            raise ValueError(f"part of {ln} chars is shorter than the {g}-mer table")
        c = queries[:, off : off + g].long()
        ok = ((c >= 1) & (c <= 4)).all(dim=1)
        code = torch.zeros(nq, dtype=torch.int64, device=text.device)
        for j in range(g):
            code = code * 4 + (c[:, j] - 1).clamp(0, 3)
        lo = torch.searchsorted(text.keys, code)
        hi = torch.searchsorted(text.keys, code, right=True)
        cnt = torch.where(ok, hi - lo, 0)
        qi = torch.repeat_interleave(torch.arange(nq, device=text.device), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        rank = torch.arange(qi.shape[0], device=text.device) - first[qi]
        t = text.at[lo[qi] + rank]
        for delta in range(-k, k + 1):
            q_all.append(qi)
            p_all.append(t - off + delta)
    q = torch.cat(q_all)
    p = torch.cat(p_all)
    inside = (p >= 0) & (p < text.n)  # a hit's first char is a text char
    key = torch.unique(q[inside] * text.n + p[inside])
    return key // text.n, key % text.n


def score(text: Text, queries: torch.Tensor, qi: torch.Tensor, start: torch.Tensor, k: int) -> torch.Tensor:
    """int64[L]: the least edits of query ``qi[l]`` against a span starting
    at ``start[l]`` (INF above k).

    Row i of the programme is the query prefix of i chars; its 2k+1 cells
    are the span prefixes of j = i - k + c chars, c = 0..2k.  Text char j
    of the span is ``start + j - 1``."""
    m = queries.shape[1]
    band = 2 * k + 1
    cols = torch.arange(band, device=text.device)
    win = text.window(start - k - 1, m + 2 * k + 1)  # span char j of row i sits at column i + c
    q = queries[qi]
    row = torch.where(cols == k, 0, INF).expand(len(qi), band).clone()  # j = 0: the empty prefixes
    for i in range(1, m + 1):
        j = i - k + cols
        tch = win[:, i : i + band]
        cost = torch.where(tch == 0, INF, (tch != q[:, i - 1 : i]).long())
        diag = row + cost
        up = torch.cat([row[:, 1:], torch.full_like(row[:, :1], INF)], dim=1) + 1  # query char i inserted
        cur = torch.minimum(diag, up)
        cur = torch.where(j < 0, INF, torch.where(j == 0, i, cur))
        can_delete = (j >= 2) & (tch != 0)  # never the span's first char, never a separator
        out = [cur[:, 0]]
        for c in range(1, band):
            out.append(torch.where(can_delete[:, c], torch.minimum(cur[:, c], out[-1] + 1), cur[:, c]))
        row = torch.stack(out, dim=1).clamp(max=INF)
    last_j = m - k + cols
    return torch.where(last_j >= 1, row, INF).min(dim=1).values


def hits(text: Text, queries: np.ndarray, k: int, block: int = 1 << 20) -> dict[str, np.ndarray]:
    """The rows of ``queries`` (uint8[nq, m]) as int64 host arrays
    ``query``, ``seq``, ``pos``, ``errors``, sorted by (query, seq, pos)."""
    qd = torch.from_numpy(np.ascontiguousarray(queries)).to(text.device)
    qi, start = candidates(text, qd, k)
    keep_q, keep_p, keep_e = [], [], []
    for b in range(0, len(qi), block):
        e = score(text, qd, qi[b : b + block], start[b : b + block], k)
        ok = e <= k
        keep_q.append(qi[b : b + block][ok])
        keep_p.append(start[b : b + block][ok])
        keep_e.append(e[ok])
    q = torch.cat(keep_q).cpu().numpy() if keep_q else np.zeros(0, dtype=np.int64)
    p = torch.cat(keep_p).cpu().numpy() if keep_p else np.zeros(0, dtype=np.int64)
    e = torch.cat(keep_e).cpu().numpy() if keep_e else np.zeros(0, dtype=np.int64)
    seq = np.searchsorted(text.starts, p, side="right") - 1
    order = np.lexsort((p, q))  # p orders seq too
    return dict(query=q[order], seq=seq[order], pos=(p - text.starts[seq])[order], errors=e[order])


def g_for(m: int, k: int) -> int:
    """The table's g-mer length for m-char queries at k errors: the
    shortest part, at most ``MAX_G``."""
    return min(MAX_G, min(ln for _, ln in parts_of(m, k)))
