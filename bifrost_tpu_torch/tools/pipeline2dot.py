"""pipeline2dot — export a live bifrost_tpu_torch pipeline's block/ring
graph as graphviz dot, read entirely from its proclog tree (the port's
copy of tools/pipeline2dot.py, reading the tree bifrost_tpu_torch
writes; reference tools/pipeline2dot.py — node roles, dtype-labelled
edges, core-sharing associations).

Features:
  * one subgraph per live pipeline process (or explicit PIDs)
  * node shape by role: source=ellipse, transform=box, sink=octagon
  * node fill shaded by ring-stall % (green=streaming, red=starved)
  * edges labelled with the stream dtype/shape parsed from the writer's
    sequence header, plus the ring name
  * dashed "association" edges between blocks pinned to the same CPU core
  * --rings renders rings as first-class nodes with capacity and space
    ('cuda' for a ring in the card's memory)

Pipe into `dot -Tpng -o graph.png` or `dot -Tsvg`.

Usage: python -m bifrost_tpu_torch.tools.pipeline2dot [-r] [pid ...]
"""

import argparse
import json
import sys

from ..memory import SPACEMAP_INV
from ..proclog import load_by_pid, list_pids, stall_pct, cmdline


def _esc(s):
    """Make a string safe inside a double-quoted dot label (same policy
    as Pipeline.dot_graph: double quotes become singles).  Backslashes
    are left alone — callers compose dot's own \\n escapes."""
    return str(s).replace('"', "'")


def _block_rings(logs):
    """(input ring names, output ring names) for one block's proclog."""
    rins, routs = [], []
    for log, target in (("in", rins), ("out", routs)):
        for key, val in logs.get(log, {}).items():
            if key.startswith("ring") and str(val) not in target:
                target.append(str(val))
    return rins, routs


def _stream_label(logs):
    """dtype/shape edge label from the block's last sequence header."""
    hdr = logs.get("sequence0", {}).get("header")
    if not hdr:
        return None
    try:
        tensor = json.loads(hdr)["_tensor"]
    except (ValueError, KeyError, TypeError):
        return None
    shape = "x".join(str(n) if n != -1 else "T"
                     for n in tensor.get("shape", []))
    return f"{tensor.get('dtype', '?')} [{shape}]"


def _stall_color(pct):
    """green (0% stall) .. red (100%) as an HSV dot color string."""
    if pct is None:
        return "white"
    hue = max(0.0, (1.0 - pct / 100.0)) * 0.33  # 0.33=green, 0=red
    return f"{hue:.3f} 0.3 1.0"


def pipeline_to_dot(pid, show_associations=True, show_rings=False,
                    show_perf=True):
    tree = load_by_pid(pid)
    blocks = {b: logs for b, logs in tree.items() if b != "rings"}
    ring_geom = tree.get("rings", {})

    ring_writer, ring_readers = {}, {}
    roles = {}
    for block, logs in blocks.items():
        rins, routs = _block_rings(logs)
        if not rins and not routs:
            continue
        for r in routs:
            ring_writer[r] = block
        for r in rins:
            ring_readers.setdefault(r, []).append(block)
        roles[block] = ("source" if not rins else
                        "sink" if not routs else "transform")

    shape = {"source": "ellipse", "transform": "box", "sink": "octagon"}
    out = [f'subgraph "cluster_{pid}" {{',
           f'  label="pid {pid}\\n{_esc(cmdline(pid))[:60]}";',
           '  labeljust=l;']
    for block in sorted(roles):
        logs = blocks[block]
        pct = stall_pct(logs.get('perf', {})) if show_perf else None
        extra = f"\\nstall {pct:.0f}%" if pct is not None else ""
        core = logs.get("bind", {}).get("core", -1)
        if isinstance(core, (int, float)) and core >= 0:
            extra += f"\\ncore {int(core)}"
        out.append(
            f'  "{pid}.{block}" [label="{_esc(block)}{extra}", '
            f'shape={shape[roles[block]]}, style="rounded,filled", '
            f'fillcolor="{_stall_color(pct)}"];')

    def ring_node_label(ring):
        kv = ring_geom.get(ring, {})
        cap = kv.get("capacity")
        label = ring
        if cap:
            space = SPACEMAP_INV.get(kv.get("space"), "")
            label += f"\\n{int(cap * kv.get('nringlet', 1))} B {space}"
        return label

    drawn_rings = set()
    for ring, readers in sorted(ring_readers.items()):
        src = ring_writer.get(ring)
        label = _stream_label(blocks.get(src, {})) if src else None
        elabel = _esc(f"{ring}" + (f"\\n{label}" if label else ""))
        for dst in readers:
            if show_rings:
                rnode = f"{pid}.ring.{ring}"
                if ring not in drawn_rings:
                    drawn_rings.add(ring)
                    out.append(f'  "{rnode}" [label='
                               f'"{_esc(ring_node_label(ring))}", '
                               f'shape=cylinder, '
                               f'fillcolor=lightgray, style=filled];')
                    if src:
                        out.append(f'  "{pid}.{src}" -> "{rnode}";')
                out.append(f'  "{rnode}" -> "{pid}.{dst}";')
            elif src:
                out.append(f'  "{pid}.{src}" -> "{pid}.{dst}" '
                           f'[label="{elabel}"];')
            else:
                out.append(f'  "{pid}.{ring}" [shape=cylinder];')
                out.append(f'  "{pid}.{ring}" -> "{pid}.{dst}";')

    if show_associations:
        by_core = {}
        for block in roles:
            core = blocks[block].get("bind", {}).get("core", -1)
            if isinstance(core, (int, float)) and core >= 0:
                by_core.setdefault(int(core), []).append(block)
        for core, members in sorted(by_core.items()):
            members = sorted(members)
            for i, a in enumerate(members):
                for b in members[i + 1:]:
                    out.append(f'  "{pid}.{a}" -> "{pid}.{b}" '
                               f'[style=dashed, dir=none, '
                               f'label="core {core}"];')
    out.append("}")
    return "\n".join(out)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="export live pipeline graphs as graphviz dot",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("pids", type=int, nargs="*",
                        help="pipeline PIDs (default: all live)")
    parser.add_argument("-o", "--output", default=None,
                        help="write dot to this file instead of stdout")
    parser.add_argument("-n", "--no-associations", action="store_true",
                        help="omit same-core association edges")
    parser.add_argument("-r", "--rings", action="store_true",
                        help="draw rings as first-class nodes")
    parser.add_argument("--no-perf", action="store_true",
                        help="omit stall %% shading/labels")
    args = parser.parse_args(argv)

    pids = [p for p in args.pids if load_by_pid(p)] if args.pids else \
        list_pids(pipelines_only=True)
    if not pids:
        print("no live bifrost_tpu_torch pipelines found", file=sys.stderr)
        return 1
    body = "\n".join(
        pipeline_to_dot(pid,
                        show_associations=not args.no_associations,
                        show_rings=args.rings,
                        show_perf=not args.no_perf)
        for pid in pids)
    dot = ('digraph pipelines {\n  rankdir=LR;\n'
           '  node [fontname="Helvetica"]; edge [fontsize=9];\n'
           + body + "\n}")
    if args.output:
        with open(args.output, "w") as f:
            f.write(dot + "\n")
    else:
        print(dot)
    return 0


if __name__ == "__main__":
    sys.exit(main())
