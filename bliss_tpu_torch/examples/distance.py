"""Print the distance between two songs (counterpart of
examples/distance.py; the reference's examples/distance.rs).

Usage: python -m bliss_tpu_torch.examples.distance [--device cuda] <song1> <song2>
"""

import argparse
import sys

from ..io.decoder import DefaultDecoder
from ..playlist import euclidean_distance


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m bliss_tpu_torch.examples.distance")
    ap.add_argument("songs", nargs="*")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if len(args.songs) != 2:
        print("usage: distance.py <song1> <song2>", file=sys.stderr)
        return 1
    song1 = DefaultDecoder.song_from_path(args.songs[0], device=args.device)
    song2 = DefaultDecoder.song_from_path(args.songs[1], device=args.device)
    d = euclidean_distance(song1.analysis.as_arr1(), song2.analysis.as_arr1())
    print(f"d({song1.path}, {song2.path}) = {d}")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # e.g. piped into `head`
        sys.exit(0)
