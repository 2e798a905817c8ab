"""Package version (reference analogue: flake_get_version, encode.c:1028-1038)."""

__version__ = "0.1.0"


def get_version() -> str:
    return __version__
