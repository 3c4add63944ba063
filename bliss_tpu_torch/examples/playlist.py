"""Make a playlist from a folder of songs, caching analyses in JSON
(counterpart of examples/playlist.py; the reference's
examples/playlist.rs): analyze every audio file in a folder (reusing a
JSON cache), order all songs by distance to the first one and write an
m3u list.

Usage: python -m bliss_tpu_torch.examples.playlist <folder> [-o out.m3u]
           [-a cache.json] [--device cuda]
"""

import argparse
import json
import pathlib
import sys
import tempfile

from .. import Analysis, FeaturesVersion, Song
from ..io.decoder import DefaultDecoder
from ..playlist import closest_to_songs, euclidean_distance

AUDIO_EXTENSIONS = {
    ".flac", ".mp3", ".ogg", ".wav", ".m4a", ".opus", ".aif", ".aiff",
}


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m bliss_tpu_torch.examples.playlist")
    parser.add_argument("folder")
    parser.add_argument("-o", "--output", default=None)
    parser.add_argument(
        "-a", "--analysis-cache",
        default=str(pathlib.Path(tempfile.gettempdir()) / "analysis.json"),
    )
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    cache_path = pathlib.Path(args.analysis_cache)
    cache = {}
    if cache_path.exists():
        cache = json.loads(cache_path.read_text())

    paths = sorted(
        str(p)
        for p in pathlib.Path(args.folder).rglob("*")
        if p.suffix.lower() in AUDIO_EXTENSIONS
    )
    songs = []
    to_analyze = [p for p in paths if p not in cache]
    for path, result in DefaultDecoder.analyze_paths(to_analyze, device=args.device):
        if isinstance(result, Exception):
            print(f"error analyzing {path}: {result}", file=sys.stderr)
        else:
            cache[str(path)] = result.analysis.as_vec()
    cache_path.write_text(json.dumps(cache))

    for p in paths:
        if p in cache:
            songs.append(
                Song(
                    path=p,
                    analysis=Analysis(cache[p], FeaturesVersion.latest()),
                )
            )
    if not songs:
        print("no analyzable songs found", file=sys.stderr)
        return 1

    playlist = closest_to_songs([songs[0]], songs, euclidean_distance, device=args.device)
    lines = [str(s.path) for s in playlist]
    if args.output:
        pathlib.Path(args.output).write_text("\n".join(lines) + "\n")
    else:
        print("\n".join(lines))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # e.g. piped into `head`
        sys.exit(0)
