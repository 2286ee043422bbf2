"""Times ``chip_smoke.py``'s embedding-bag checks (phase 3's ``check_bag`` and
``check_bag_bwd``) of one or more checkouts on one CUDA card, each checkout
in a process of its own, so that two versions of the checks compare on the
same card in one run:

    python3 tools/time_bag_checks.py OUT.jsonl TREE [TREE ...]

Each TREE is the root of a checkout (its ``chip_smoke.py`` and ``src/``),
e.g. the parent commit unpacked by ``git archive`` into ``build/parent``
and ``.``, in the order parent, change, change, parent.  The kernels of each
tree are built from its own sources before the clock starts, and the
profiler is started once first, as the earlier phases of ``chip_smoke.py``
leave it.  Prints, and appends to OUT.jsonl, one JSON line a run: the tree,
the wall seconds of ``check_bag``, of ``check_bag_bwd`` and of both with the
cache frees between them (``chip_smoke.py``'s ``t_bag`` span), and the
card's ``nvidia-smi`` name and power limit.  The checks' own output goes to
OUT.jsonl's directory, one log a run.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path


def one(tree: Path) -> dict:
    """Runs the bag checks of the checkout at ``tree`` once; their seconds."""
    spec = importlib.util.spec_from_file_location("chip_smoke_of_tree", tree / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)  # puts tree/src first on sys.path
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_bwd
    from repro_torch.kernels.ref import ref_embedding_bag, ref_embedding_bag_bwd

    if not torch.cuda.is_available():
        raise SystemExit("time_bag_checks: no CUDA device")
    assert Path(_build.__file__).resolve().is_relative_to(tree.resolve()), _build.__file__
    for name in ("embedding_bag", "embedding_bag_bwd"):
        _build.load(name)
    dev = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    cs.kernel_device_ms(lambda: torch.zeros(1, device=dev), 1)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs.check_bag(embedding_bag, ref_embedding_bag, gen, dev, smi)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    cs.check_bag_bwd(embedding_bag_bwd, ref_embedding_bag_bwd, gen, dev, smi)
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    return dict(tree=str(tree), check_bag_s=t1 - t0, check_bag_bwd_s=t2 - t1,
                bag_checks_s=t2 - t0, card=smi)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(Path(argv[1]))))
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    out = Path(argv[0])
    out.parent.mkdir(parents=True, exist_ok=True)
    for i, tree in enumerate(argv[1:]):
        log = out.parent / f"{out.stem}.{i}.log"
        with open(log, "w") as f:
            proc = subprocess.run([sys.executable, __file__, "--one", tree], stdout=f,
                                  stderr=subprocess.STDOUT, text=True)
        last = log.read_text().strip().splitlines()[-1:]
        if proc.returncode != 0 or not last:
            print(f"time_bag_checks: {tree} failed ({proc.returncode}); see {log}",
                  file=sys.stderr)
            return 1
        print(last[0], flush=True)
        with open(out, "a") as f:
            f.write(last[0] + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
