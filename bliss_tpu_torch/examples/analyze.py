"""Analyze songs and print their feature vectors (counterpart of
examples/analyze.py; the reference's examples/analyze.rs).

Usage: python -m bliss_tpu_torch.examples.analyze [--device cuda] <song> [...]
"""

import argparse
import sys

from ..io.decoder import DefaultDecoder


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m bliss_tpu_torch.examples.analyze")
    ap.add_argument("songs", nargs="*")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not args.songs:
        print("usage: analyze.py <song> [...]", file=sys.stderr)
        return 1
    for path, result in DefaultDecoder.analyze_paths(args.songs, device=args.device):
        if isinstance(result, Exception):
            print(f"error analyzing {path}: {result}", file=sys.stderr)
        else:
            print(f"{path}: {result.analysis.as_vec()}")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # e.g. piped into `head`
        sys.exit(0)
