"""Library with user-defined extra info per song (counterpart of
examples/library_extra_info.py; the reference's
examples/library_extra_info.rs): analyze a folder, storing an extra
serializable payload alongside each song.

Usage:
  python -m bliss_tpu_torch.examples.library_extra_info init <folder> -c config.json
  python -m bliss_tpu_torch.examples.library_extra_info playlist -c config.json <song> <n>
each with [--device cuda].
"""

import argparse
import pathlib
import sys

from ..library import BaseConfig, Library
from . import AUDIO_EXTENSIONS


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m bliss_tpu_torch.examples.library_extra_info")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_init = sub.add_parser("init")
    p_init.add_argument("folder")
    p_init.add_argument("-c", "--config", required=True)
    p_playlist = sub.add_parser("playlist")
    p_playlist.add_argument("song")
    p_playlist.add_argument("n", type=int)
    p_playlist.add_argument("-c", "--config", required=True)
    for p in (p_init, p_playlist):
        p.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    if args.cmd == "init":
        config = BaseConfig(config_path=pathlib.Path(args.config))
        library = Library(config, device=args.device)
        paths = sorted(
            str(p.resolve())
            for p in pathlib.Path(args.folder).rglob("*")
            if p.suffix.lower() in AUDIO_EXTENSIONS
        )
        # extra info: the file size and the folder it came from
        paths_extra_info = [
            (p, {"size": pathlib.Path(p).stat().st_size, "root": args.folder})
            for p in paths
        ]
        library.analyze_paths_extra_info(paths_extra_info, True)
    else:
        library = Library.from_config_path(args.config, device=args.device)
        for song in library.playlist_from([args.song])[: args.n]:
            print(song.bliss_song.path, song.extra_info)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # e.g. piped into `head`
        sys.exit(0)
