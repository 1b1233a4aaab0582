"""TikZ rendering of search trees: enumerate the error configurations of a
(hamming-limited, expanded) search and emit a LaTeX/TikZ picture of the
search tree with part-boundary lines.  A copy of ``sahara_tpu/tikz.py``."""

from __future__ import annotations

from sahara_tpu_torch.schemes.expand import expand_search, limit_to_hamming
from sahara_tpu_torch.schemes.types import Search


def all_error_configs(s: Search, max_step: int = 1):
    """Yield error-delta configurations level by level:
    at each level the cumulative error count may grow by at most
    ``max_step`` over the previous level's minimum."""
    out: list[list[int]] = []

    def rec(error_conf: list[int], min_error: int):
        level = len(error_conf)
        if level == len(s.pi):
            return
        error_conf.append(0)
        for i in range(max(min_error, s.l[level]), s.u[level] + 1):
            if i - min_error > max_step:
                continue
            error_conf[-1] = i - min_error
            out.append(list(error_conf))
            rec(error_conf, i)
        error_conf.pop()

    rec([], 0)
    return out


def generate_tikz(
    s: Search,
    counts: list[int],
    display_alphabet: bool = False,
    font_size: float = 4,
    zero_index: bool = True,
) -> str:
    """Render one abstract search as a TikZ search tree."""
    es = expand_search(s, counts)
    hs = limit_to_hamming([es])[0]
    pi1 = [p + 1 for p in s.pi]  # 1-indexed parts

    out = [
        "",
        r"\begin{tikzpicture}[scale=1.]",
        r"\tikzstyle{node}=[fill=white, shape=circle, draw, minimum size=0.25cm,scale=2.]",
        r"\tikzstyle{edge}=[left,scale=1.]",
        r"\tikzstyle{medge}=[scale=1.]",
        r"\tikzstyle{redge}=[right,scale=1.]",
        r"\tikzstyle{bedge}=[below,scale=1.]",
        "",
        r"\node[node] (n)       at (0, 0) {};",
    ]

    leafs = 0
    max_level = len(hs.pi)
    configs = all_error_configs(hs, 1)
    for error in configs:
        level = len(error)
        if error[-1] == 1:
            leafs += 1
        name = f"(n{''.join(map(str, error))})"
        out.append(f"\\node[node] {name} at ({leafs:2}, {-level * 2:2}) {{}};")

    for error in configs:
        level = len(error)
        name1 = f"(n{''.join(map(str, error[:-1]))})"
        name2 = f"(n{''.join(map(str, error))})"
        if error[-1] == 0:
            c = "M" if display_alphabet else " "
            out.append(f"\\draw {name1} to node[edge] {{{c}}} {name2};")
        else:
            c = "S" if display_alphabet else " "
            style = "bedge" if level < max_level else "redge"
            out.append(f"\\draw[dashed] {name1} to node[{style}] {{{c}}} {name2};")

    accum = 0
    out.append("\\node[] (sl0) at (-1, 0) {};")
    for i in range(1, len(counts)):
        accum += counts[pi1[i - 1] - 1]
        out.append(f"\\node[] (sl{i}) at ({-1:2}, {-accum * 2:2}) {{}};")
        out.append(f"\\node[] (sr{i}) at ({leafs:2}, {-accum * 2:2}) {{}};")
        out.append(f"\\draw [dashed] (sl{i}) -- (sr{i});")
    accum += counts[-1]
    out.append(f"\\node[] (sl{len(counts)}) at (-1, {-accum * 2:2}) {{}};")

    for i in range(len(counts)):
        label = pi1[i] - (1 if zero_index else 0)
        out.append(
            f"\\path [] (sl{i}) -- node [midway,left,scale={font_size}] {{P{label}}} (sl{i + 1});"
        )
    out.append("")
    out.append(r"\end{tikzpicture}")
    return "\n".join(out)
