"""Full paper reproduction demo on the PyTorch port: NPB criticality maps
(paper Figs 3-8), Table II/III, and the §IV-C restart-verification
protocol.

    PYTHONPATH=src python examples/torch/npb_checkpoint_demo.py \\
        [--device cpu] [bench ...]

Runs on the card unless ``--device cpu`` is given.
"""

import argparse

from repro_torch.core.report import (render_distribution, storage_table,
                                     summary_table)
from repro_torch.npb.common import (ALL_BENCHMARKS, get_benchmark,
                                    verify_restart)

FIG_SHAPES = {  # variable -> shape to render (paper figures)
    ("bt", "u"): (12, 13, 13, 5), ("sp", "u"): (12, 13, 13, 5),
    ("mg", "u"): (46480,), ("mg", "r"): (46480,),
    ("cg", "x"): (1402,), ("ft", "y"): (64, 64, 65),
    ("lu", "u"): (12, 13, 13, 5),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("benches", nargs="*")
    args = ap.parse_args(argv)
    for name in args.benches or list(ALL_BENCHMARKS):
        b = get_benchmark(name, device=args.device)
        rep = b.participation()
        print(summary_table(rep, title=f"{name.upper()} (participation)"))
        print(storage_table(rep))
        for var, leaf in sorted(rep.leaves.items()):
            shape = FIG_SHAPES.get((name, var))
            if shape and leaf.uncritical:
                print(f"\n-- {name}({var}) criticality map "
                      f"(#=critical .=uncritical) --")
                if len(shape) == 4:  # render one component plane like Fig 3
                    mask = leaf.mask.reshape(shape)[..., 0]
                    print(render_distribution(mask.reshape(-1),
                                              mask.shape, max_planes=3))
                else:
                    print(render_distribution(leaf.mask, shape, max_planes=3))
        ok = verify_restart(b, rep)
        ok_u = verify_restart(b, rep, corrupt="uncritical")
        print(f"\n{name}: restart={ok} corrupt-uncritical-still-passes={ok_u}")
        print("=" * 72)


if __name__ == "__main__":
    main()
