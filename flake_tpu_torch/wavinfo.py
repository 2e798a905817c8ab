"""``wavinfo`` diagnostic tool: dump WAVE file header information (port
of ``flake_tpu/wavinfo.py``; ``python -m flake_tpu_torch.wavinfo``).

Reference analogue: util/wavinfo.c — prints the fields the benchmark
scripts consume ("Data Size", "Playing Time", wavinfo.c:273-325), with
the same format-tag name table.
"""

from __future__ import annotations

import sys

from flake_tpu_torch.io import open_pcm

# WAVE format tag names (wavinfo.c:11-260, condensed to common tags)
FORMAT_NAMES = {
    0x0001: "PCM",
    0x0002: "Microsoft ADPCM",
    0x0003: "IEEE Float",
    0x0006: "A-law",
    0x0007: "Mu-law",
    0x0011: "IMA ADPCM",
    0x0050: "MPEG-1",
    0x0055: "MPEG Layer 3",
    0xFFFE: "Extensible",
}


def wavinfo_print(fname: str, info, out=None) -> None:
    out = out or sys.stdout
    out.write(f"File: {fname}\n")
    fmt_tag = 0x0003 if info.float_fmt else 0x0001
    name = FORMAT_NAMES.get(fmt_tag, "Unknown")
    out.write(f"Format: {name} ({fmt_tag:#06x})\n")
    out.write(f"Channels: {info.channels}\n")
    if info.channel_mask:
        out.write(f"Channel Mask: {info.channel_mask:#x}\n")
    out.write(f"Sample Rate: {info.sample_rate} Hz\n")
    out.write(f"Bit Width: {info.bits_per_sample}\n")
    out.write(f"Block Align: {info.block_align}\n")
    data_size = info.data_size if info.data_size is not None else 0
    out.write(f"Data Size: {data_size}\n")
    secs = info.duration
    ms = int(round((secs - int(secs)) * 1000))
    m, s = divmod(int(secs), 60)
    h, m = divmod(m, 60)
    out.write(f"Playing Time: {h}h {m}m {s}s {ms}ms\n")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        sys.stderr.write("usage: wavinfo <file.wav> [...]\n")
        return 1
    for fname in argv:
        try:
            fp = sys.stdin.buffer if fname == "-" else open(fname, "rb")
            reader = open_pcm(fp, forced_format="wave")
            wavinfo_print(fname, reader.info)
            if fname != "-":
                fp.close()
        except (ValueError, OSError) as e:
            sys.stderr.write(f"error reading {fname}: {e}\n")
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
