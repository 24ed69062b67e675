"""ptxas's lines (registers, stack frame, spills) of every kernel instance
of a checkout's ``tpu_qg_torch/csrc/*.cu``, compiled with the port's nvcc
flags (``ops/_build.py``), one process a source, all started together; an
instance is named by its mangled name with the anonymous namespace's
per-source hash removed, so that two checkouts' names match. With
``--compare ROOT`` it builds both checkouts at once and prints the
instances whose lines differ, those only this checkout has with their
lines, and those only the other has:

    python3 -m tpu_qg_torch.scripts.ptxas_lines                  # this checkout
    python3 -m tpu_qg_torch.scripts.ptxas_lines --compare runs/parent

It needs the CUDA toolkit (nvcc), so it runs on the machine with the card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import tempfile

from tpu_qg_torch.ops import _build

_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_[A-Za-z0-9_]+?_cu_[0-9a-f]+")
_HERE = pathlib.Path(__file__).resolve().parents[2]


def _start(root: pathlib.Path, out: pathlib.Path) -> list:
    srcs = sorted((root / "tpu_qg_torch" / "csrc").glob("*.cu"))
    return [subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o",
         str(out / f"{src.stem}.o"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in srcs]


def _lines(procs: list) -> dict:
    """{instance: [ptxas lines]} from the compilers' output."""
    out, name = {}, None
    for proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{log}")
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                name = _ANON.sub("ANON", ln.split("'")[1])
            elif name and ("registers" in ln or "spill" in ln):
                out.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--compare", type=pathlib.Path, default=None,
                    help="root of another checkout to compare with")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        mine = _start(_HERE, pathlib.Path(tmp))
        other = None
        if args.compare is not None:
            (pathlib.Path(tmp) / "other").mkdir()
            other = _start(args.compare.resolve(), pathlib.Path(tmp) / "other")
        lines = _lines(mine)
        if other is None:
            print(json.dumps({"instances": len(lines), "lines": lines}))
            return
        theirs = _lines(other)
    print(json.dumps({
        "instances": len(lines), "compared_instances": len(theirs),
        "differ": {k: {"this": lines[k], "other": v}
                   for k, v in theirs.items() if k in lines and lines[k] != v},
        "only_this": {k: lines[k] for k in sorted(set(lines) - set(theirs))},
        "only_other": sorted(set(theirs) - set(lines))}))


if __name__ == "__main__":
    main()
