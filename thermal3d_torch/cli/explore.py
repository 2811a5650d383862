"""Dataset exploration — `python -m thermal3d_torch.cli.explore` (counterpart
of thermal3d/cli/explore.py).

The directory census (data/exploration.py) and, with --samples N, the
drive-folder sample panels RGB | IR | overlay (viz/sampler.py::
visualize_dataset). Runs on the host: no model, no card.
"""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Explore a Freiburg-style dataset")
    p.add_argument("--dataset_dir", type=str, required=True)
    p.add_argument("--max_depth", type=int, default=4,
                   help="directory-walk depth for the census")
    p.add_argument("--samples", type=int, default=0,
                   help="also write N RGB|IR|overlay sample panels (0 = census only)")
    p.add_argument("--output_dir", type=str, default="freiburg_samples",
                   help="where sample panels go (with --samples)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from thermal3d_torch.data.exploration import explore_dataset

    report = explore_dataset(args.dataset_dir, max_depth=args.max_depth)
    print(json.dumps(report, indent=2))
    if args.samples > 0:
        from thermal3d_torch.viz.sampler import visualize_dataset

        n = visualize_dataset(args.dataset_dir, num_samples=args.samples,
                              output_dir=args.output_dir)
        print(f"Wrote {n} sample panels -> {args.output_dir}")
    return report


if __name__ == "__main__":
    main()
