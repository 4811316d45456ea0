"""Normalize score JSONs to [0,1] (global min-max) — counterpart of
reference manual-experiments/normalize_scores.py.

  python -m ssp_x_vit_tpu_torch.cli.normalize_scores scores/*.json --out-dir normalized/

The port's copy of ``ssp_x_vit_tpu/cli/normalize_scores.py``: the same flags, log lines
and output bytes; host code, no device.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ssp_x_vit_tpu_torch.masks.normalize import normalize_file


def build_argparser():
    p = argparse.ArgumentParser(description="Global min-max normalize all numeric values in JSON files.")
    p.add_argument("files", nargs="+", help="Input JSON files")
    p.add_argument("--out-dir", type=str, default=None,
                   help="Output directory (default: 'normalized' beside each input)")
    p.add_argument("--inplace", action="store_true", help="Overwrite inputs (a .bak backup is kept)")
    p.add_argument("--dry-run", action="store_true")
    return p


def main():
    args = build_argparser().parse_args()
    for src in args.files:
        src = Path(src)
        if args.inplace:
            dst = src
            if not args.dry_run:
                backup = src.with_suffix(src.suffix + ".bak")
                backup.write_bytes(src.read_bytes())
        elif args.out_dir:
            dst = Path(args.out_dir) / src.name
        else:
            dst = src.parent / "normalized" / src.name
        normalize_file(src, dst, dry_run=args.dry_run)


if __name__ == "__main__":
    main()
