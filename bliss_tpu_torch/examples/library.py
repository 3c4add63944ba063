"""Library CLI: init / update / playlist (counterpart of
examples/library.py; the reference's examples/library.rs).

Usage:
  python -m bliss_tpu_torch.examples.library init <folder> -c config.json [-d songs.db]
  python -m bliss_tpu_torch.examples.library update -c config.json <folder>
  python -m bliss_tpu_torch.examples.library playlist -c config.json <song path> <n>
each with [--device cuda].
"""

import argparse
import pathlib
import sys

from ..library import BaseConfig, Library
from . import AUDIO_EXTENSIONS


def _folder_paths(folder):
    return sorted(
        str(p.resolve())
        for p in pathlib.Path(folder).rglob("*")
        if p.suffix.lower() in AUDIO_EXTENSIONS
    )


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m bliss_tpu_torch.examples.library")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_init = sub.add_parser("init")
    p_init.add_argument("folder")
    p_init.add_argument("-c", "--config", required=True)
    p_init.add_argument("-d", "--database", default=None)

    p_update = sub.add_parser("update")
    p_update.add_argument("folder")
    p_update.add_argument("-c", "--config", required=True)

    p_playlist = sub.add_parser("playlist")
    p_playlist.add_argument("song")
    p_playlist.add_argument("n", type=int)
    p_playlist.add_argument("-c", "--config", required=True)

    for p in (p_init, p_update, p_playlist):
        p.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    if args.cmd == "init":
        config = BaseConfig(
            config_path=pathlib.Path(args.config),
            database_path=(
                pathlib.Path(args.database) if args.database else None
            ),
        )
        library = Library(config, device=args.device)
        library.analyze_paths(_folder_paths(args.folder), show_progress_bar=True)
    elif args.cmd == "update":
        library = Library.from_config_path(args.config, device=args.device)
        library.update_library(
            _folder_paths(args.folder),
            delete_everything_else=True,
            show_progress_bar=True,
        )
    elif args.cmd == "playlist":
        library = Library.from_config_path(args.config, device=args.device)
        playlist = library.playlist_from([args.song])
        for song in playlist[: args.n]:
            print(song.bliss_song.path)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # e.g. piped into `head`
        sys.exit(0)
