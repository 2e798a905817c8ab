"""``flake`` command-line interface of the port (port of
``flake_tpu/cli.py``): ``python -m flake_tpu_torch.cli`` or ``flake-torch``.

Flag-compatible with the reference CLI (flake/flake.c:54-98): same
options (-h -q -p -0..-12 -b -t -l -m -r -s -v -o), multi-file input,
automatic ``.flac`` naming, stdin/stdout piping, parameter dump, live
progress reporting, and the post-encode STREAMINFO rewrite. It keeps the
JAX CLI's long options (``--lpc-dtype``, ``--pack-backend``, ``--stats``)
and adds ``--device cuda|cpu`` (default ``cuda``); asking for CUDA where
there is none is an error, never a fall back to the CPU.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from flake_tpu_torch import metadata
from flake_tpu_torch import params as P
from flake_tpu_torch.encoder import Encoder, resolve_device
from flake_tpu_torch.io import open_pcm
from flake_tpu_torch.version import get_version

USAGE = "usage: flake [options] <input> [-o output.flac]\n" \
        "type 'flake -h' for more details.\n"

HELP = """usage: flake [options] <input> [-o output.flac]
options:
       [-h]         Print out list of commandline options
       [-q]         Quiet mode: no console output
       [-p #]       Padding bytes to put in header (default: 8192)
       [-0 ... -12] Compression level (default: 5)
       [-b #]       Block size [16 - 65535] (default: 4096)
       [-t #]       Prediction type
                        0 = no prediction / verbatim
                        1 = fixed prediction
                        2 = Levinson-Durbin recursion (default)
       [-l #[,#]]   Prediction order {max} or {min},{max} (default: 1,5)
       [-m #]       Prediction order selection method
                        0 = maximum
                        1 = estimate (default)
                        2 = 2-level
                        3 = 4-level
                        4 = 8-level
                        5 = full search
                        6 = log search
       [-r #[,#]]   Rice partition order {max} or {min},{max} (default: 0,5)
       [-s #]       Stereo decorrelation method
                        0 = independent L+R channels
                        1 = mid-side (default)
       [-v #]       Variable block size
                        0 = fixed (default)
                        1 = variable
GPU extensions (not in the reference CLI):
       [--device cuda|cpu]
                    Device of the analysis and the device emission
                    (default: cuda). Asking for cuda where there is
                    none is an error.
       [--lpc-dtype float64|float32]
                    LPC analysis precision. float64 matches the
                    reference's doubles bit-for-bit; float32 computes
                    the autocorrelation and the recursions in float32,
                    with a small size change. Output is losslessly
                    decodable either way.
       [--stats]    Print device/pack timing counters after encoding
       [--pack-backend auto|device|host]
                    Bitstream emission backend: 'device' packs the
                    FLAC bytes on the GPU (CUDA word merge; the copy
                    back ships ~the compressed size), 'host' uses the
                    native C++ packer; 'auto' (default) is device.
                    Output bytes are identical.
"""


class Options:
    def __init__(self):
        self.infiles: list[str] = []
        self.outfile: str | None = None
        self.compr = 5
        self.omethod = -1
        self.ptype = -1
        self.omin = -1
        self.omax = -1
        self.pomin = -1
        self.pomax = -1
        self.bsize = -1
        self.stmethod = -1
        self.padding = -1
        self.vbs = -1
        self.quiet = False
        self.lpc_dtype = "float64"
        self.pack_backend = "auto"
        self.stats = False
        self.device = "cuda"


def parse_args(argv: list[str]) -> Options | int:
    """Hand-rolled parser mirroring flake.c:149-322 (incl. '-' = stdio,
    filenames starting with '-')."""
    opts = Options()
    if not argv:
        sys.stderr.write(USAGE)
        return 1
    i = 0
    param_str = "bhlmopqrstv"
    while i < len(argv):
        arg = argv[i]
        if arg.startswith("--") and len(arg) > 2:
            # long options (the reference CLI has none; its '-xyz is a
            # filename' rule never produces '--' names)
            if arg == "--device":
                i += 1
                if i >= len(argv) or argv[i] not in ("cuda", "cpu"):
                    sys.stderr.write("--device needs cuda|cpu\n")
                    return 1
                opts.device = argv[i]
            elif arg == "--lpc-dtype":
                i += 1
                if i >= len(argv) or argv[i] not in ("float64",
                                                     "float32"):
                    sys.stderr.write("--lpc-dtype needs "
                                     "float64|float32\n")
                    return 1
                opts.lpc_dtype = argv[i]
            elif arg == "--stats":
                opts.stats = True
            elif arg == "--pack-backend":
                i += 1
                if i >= len(argv) or argv[i] not in ("auto", "device",
                                                     "host"):
                    sys.stderr.write("--pack-backend needs "
                                     "auto|device|host\n")
                    return 1
                opts.pack_backend = argv[i]
            else:
                sys.stderr.write(f"invalid option: {arg}\n")
                return 1
        elif arg.startswith("-") and len(arg) > 1:
            if arg[1].isdigit():
                if len(arg) > 3 and not arg[1:].isdigit():
                    opts.infiles.append(arg)
                else:
                    try:
                        opts.compr = int(arg[1:])
                    except ValueError:
                        return 1
            elif len(arg) > 2:
                # '-xyz' is treated as a filename (flake.c:189-195)
                opts.infiles.append(arg)
            elif arg[1] not in param_str:
                sys.stderr.write(f"invalid option: -{arg[1]}\n")
                return 1
            elif arg[1] == "h":
                sys.stdout.write(HELP)
                return 2
            elif arg[1] == "q":
                opts.quiet = True
            else:
                i += 1
                if i >= len(argv):
                    sys.stderr.write(f"incomplete option: -{arg[1]}\n")
                    return 1
                val = argv[i]
                try:
                    if arg[1] == "b":
                        opts.bsize = int(val)
                    elif arg[1] == "l":
                        if "," in val:
                            lo, hi = val.split(",", 1)
                            opts.omin, opts.omax = int(lo), int(hi)
                        else:
                            opts.omax = int(val)
                    elif arg[1] == "m":
                        opts.omethod = int(val)
                    elif arg[1] == "o":
                        if opts.outfile is not None:
                            return 1
                        opts.outfile = val
                    elif arg[1] == "p":
                        opts.padding = int(val)
                    elif arg[1] == "r":
                        if "," in val:
                            lo, hi = val.split(",", 1)
                            opts.pomin, opts.pomax = int(lo), int(hi)
                        else:
                            opts.pomin, opts.pomax = 0, int(val)
                    elif arg[1] == "s":
                        opts.stmethod = int(val)
                    elif arg[1] == "t":
                        opts.ptype = int(val)
                    elif arg[1] == "v":
                        opts.vbs = int(val)
                except ValueError:
                    return 1
        else:
            opts.infiles.append(arg)
        i += 1

    if not opts.infiles:
        sys.stderr.write("error parsing filenames.\n")
        return 1
    if opts.outfile and len(opts.infiles) > 1:
        sys.stderr.write(
            "cannot specify output file when using multiple input files\n")
        return 1
    return opts


def build_config(opts: Options, channels, sample_rate, bps,
                 samples) -> P.StreamConfig:
    """Level preset + individual overrides (flake.c:523-550)."""
    params = P.set_defaults(opts.compr)
    if opts.bsize >= 0:
        params.block_size = opts.bsize
    if opts.omethod >= 0:
        params.order_method = opts.omethod
    if opts.stmethod >= 0:
        params.stereo_method = opts.stmethod
    if opts.ptype >= 0:
        params.prediction_type = opts.ptype
    if opts.omin >= 0 or opts.omax >= 0:
        params.max_prediction_order = opts.omax
        if opts.omin >= 0:
            params.min_prediction_order = opts.omin
        else:
            params.min_prediction_order = \
                1 if params.prediction_type == P.Prediction.LEVINSON else 0
    if opts.pomin >= 0:
        params.min_partition_order = opts.pomin
    if opts.pomax >= 0:
        params.max_partition_order = opts.pomax
    if opts.padding >= 0:
        params.padding_size = opts.padding
    if opts.vbs >= 0:
        params.variable_block_size = opts.vbs
        if opts.vbs:
            params.allow_vbs = 1
    return P.StreamConfig(channels=channels, sample_rate=sample_rate,
                          bits_per_sample=bps, samples=samples,
                          params=params)


def print_params(cfg: P.StreamConfig, err):
    """Parameter dump (flake.c:324-363)."""
    p = cfg.params
    err.write(f"block size: {p.block_size}\n")
    err.write("variable block size: "
              f"{'yes' if p.variable_block_size else 'no'}\n")
    ptype = ["none (verbatim mode)", "fixed", "levinson-durbin"]
    err.write(f"prediction type: {ptype[p.prediction_type]}\n")
    if p.prediction_type != P.Prediction.NONE:
        err.write(f"prediction order: {p.min_prediction_order},"
                  f"{p.max_prediction_order}\n")
        err.write(f"partition order: {p.min_partition_order},"
                  f"{p.max_partition_order}\n")
        om = ["maximum", "estimate", "2-level", "4-level", "8-level",
              "full search", "log search"]
        err.write(f"order method: {om[p.order_method]}\n")
    if cfg.channels == 2:
        sm = ["independent", "mid-side"]
        err.write(f"stereo method: {sm[p.stereo_method]}\n")
    err.write(f"header padding: {p.padding_size}\n")


SUBSET_WARNING = """=-=-=-=-=-=-=-=-=-=-=-=-=-=-=-=-=-=-=-=-=-=-=
 WARNING! The chosen encoding options are
 not FLAC Subset compliant. Therefore, the
 encoded file(s) may not work properly with
 some FLAC players and decoders.
=-=-=-=-=-=-=-=-=-=-=-=-=-=-=-=-=-=-=-=-=-=-=

"""


def encode_file(opts: Options, infile: str, outfile: str,
                first_file: bool) -> int:
    """Read -> encode -> write loop + STREAMINFO rewrite
    (flake.c:495-689)."""
    err = sys.stderr

    if infile == "-":
        fp = sys.stdin.buffer
    else:
        fp = open(infile, "rb")
    try:
        reader = open_pcm(fp)
    except ValueError as e:
        err.write(f"\ninvalid input file: {infile} ({e})\n")
        return 1
    info = reader.info

    cfg = build_config(opts, info.channels, info.sample_rate,
                       info.bits_per_sample, info.samples)
    try:
        subset = P.validate_params(cfg)
    except ValueError as e:
        err.write(f"Error: invalid encoding parameters ({e}).\n")
        return 1

    enc = Encoder(cfg, device=opts.device, lpc_dtype=opts.lpc_dtype,
                  pack_backend=opts.pack_backend)
    out_is_pipe = outfile == "-"
    ofp = sys.stdout.buffer if out_is_pipe else open(outfile, "wb")

    header = enc.header()
    ofp.write(header)

    if first_file and not opts.quiet:
        if subset == 1:
            err.write(SUBSET_WARNING)
        print_params(cfg, err)
    if not opts.quiet:
        err.write(f"\ninput file:  \"{infile}\"\n")
        err.write(f"output file: \"{outfile}\"\n")
        err.write(f"format: {info.format_name} {info.sample_rate} Hz, "
                  f"{info.channels} ch, {info.bits_per_sample}-bit\n")
        if info.samples:
            secs = info.samples / info.sample_rate
            err.write(f"samples: {info.samples} ({secs:.3f}s)\n")
        else:
            err.write("samples: unknown\n")
        err.write("\n")

    bs = cfg.params.block_size
    # feed the encoder whole device batches (two a read); the ~64 MB
    # PCM clamp (memory safety on huge blocks) may yield fewer than
    # batch_frames frames per read, in which case device batches are
    # zero-padded
    chunk_frames = max(1, min(2 * enc.batch_frames,
                              (1 << 26) // max(bs * info.channels * 4, 1)))
    bytecount = len(header)
    samplecount = 0
    block_align = info.bits_per_sample * info.channels / 8
    t0 = time.time()
    while True:
        pcm = reader.read_samples(bs * chunk_frames)
        if pcm.shape[0] == 0:
            break
        frames = enc.encode(pcm)
        ofp.write(frames)
        bytecount += len(frames)
        samplecount += pcm.shape[0]
        if not opts.quiet and info.samples:
            pct = int(samplecount * 100.5 / info.samples)
            sec = samplecount / info.sample_rate
            kbps = (bytecount * 8.0 / 1000.0) / max(sec, 1e-9)
            ratio = bytecount / max(samplecount * block_align, 1)
            err.write(f"\rprogress: {pct:3d}% | ratio: {ratio:1.3f} | "
                      f"bitrate: {kbps:4.1f} kbps ")
    tail = enc.finish()
    ofp.write(tail)
    bytecount += len(tail)
    if not opts.quiet:
        wall = time.time() - t0
        speed = (samplecount / info.sample_rate) / max(wall, 1e-9)
        err.write(f"| bytes: {bytecount} | {speed:.1f}x realtime \n\n")
    if opts.stats:
        s = enc.stats
        err.write(f"stats: frames={s['frames']} batches={s['batches']} "
                  f"device_wait={s['device_wait_seconds']:.3f}s "
                  f"fetch={s['fetch_seconds']:.3f}s "
                  f"pack={s['pack_seconds']:.3f}s "
                  f"bytes_out={s['bytes_out']}\n")

    # rewrite streaminfo if output is seekable (flake.c:669-678)
    enc.sample_count = samplecount
    if not out_is_pipe:
        ofp.seek(8)
        ofp.write(metadata.write_streaminfo(enc.streaminfo()))
        ofp.close()
    if infile != "-":
        fp.close()
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts = parse_args(argv)
    if isinstance(opts, int):
        return 0 if opts == 2 else opts
    try:
        resolve_device(opts.device)
    except RuntimeError as e:
        sys.stderr.write(f"error: {e}\n")
        return 1

    if not opts.quiet:
        sys.stderr.write(f"\nFlake-TPU on PyTorch/CUDA: FLAC audio "
                         f"encoder\n"
                         f"version {get_version()}\n"
                         f"(c) 2026 flake-tpu contributors\n\n")

    rc = 0
    for idx, infile in enumerate(opts.infiles):
        if opts.outfile:
            outfile = opts.outfile
        elif infile == "-":
            outfile = "-"
        else:
            base, _ = os.path.splitext(infile)
            outfile = base + ".flac"
        if infile != "-" and outfile != "-" and \
                os.path.abspath(infile) == os.path.abspath(outfile):
            sys.stderr.write(
                "output filename cannot match input filename\n")
            return 1
        rc = encode_file(opts, infile, outfile, idx == 0)
        if rc:
            sys.stderr.write(f"error encoding {infile}\n")
            break
    return rc


if __name__ == "__main__":
    sys.exit(main())
