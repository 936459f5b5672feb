"""Parameter summary printed when a fit starts (``enable_model_summary``):
the JAX package's ``utils/summary.py`` table, grouped by the tree's
top-level keys, for a tree of tensors."""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch


def _walk(tree: Any, path: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out.extend(_walk(v, path + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_walk(v, path + (str(i),)))
        return out
    return [(path, tree)]


def summarize_params(params: Any, depth: int = 1) -> str:
    """Human-readable parameter table: per group (path prefix of ``depth``
    keys) the parameter count, bytes, dtypes and devices."""
    rows: Dict[str, Dict[str, Any]] = {}
    total = total_bytes = 0
    for path, leaf in _walk(params):
        group = ".".join(path[:depth]) if path else "(root)"
        t = torch.as_tensor(leaf)
        n, nbytes = t.numel(), t.numel() * t.element_size()
        row = rows.setdefault(
            group, {"params": 0, "bytes": 0, "dtypes": set(), "devices": set()}
        )
        row["params"] += n
        row["bytes"] += nbytes
        row["dtypes"].add(str(t.dtype).replace("torch.", ""))
        row["devices"].add(t.device.type)
        total += n
        total_bytes += nbytes

    def fmt_n(n: int) -> str:
        for unit, div in (("B", 1e9), ("M", 1e6), ("K", 1e3)):
            if n >= div:
                return f"{n / div:.1f} {unit}"
        return str(n)

    name_w = max([len(g) for g in rows] + [5])
    head = f"{'name':<{name_w}} | {'params':>8} | {'bytes':>8} | dtype | device"
    lines = [head, "-" * len(head)]
    for group, row in rows.items():
        lines.append(
            f"{group:<{name_w}} | {fmt_n(row['params']):>8} | "
            f"{fmt_n(row['bytes']):>8} | {','.join(sorted(row['dtypes']))} | "
            f"{','.join(sorted(row['devices']))}"
        )
    lines.append("-" * len(head))
    lines.append(
        f"{'total':<{name_w}} | {fmt_n(total):>8} | {fmt_n(total_bytes):>8} |"
        f" {len(rows)} groups"
    )
    return "\n".join(lines)
