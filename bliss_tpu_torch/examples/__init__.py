"""The command-line examples of the port (counterparts of the repo's
examples/*.py), each run as `python -m bliss_tpu_torch.examples.<name>`
and each taking `--device` (default `cuda`; `cpu` runs the plain PyTorch
path)."""

#: The extensions the folder-scanning examples pick up.
AUDIO_EXTENSIONS = {".flac", ".mp3", ".ogg", ".wav", ".m4a", ".opus", ".cue"}
