"""Minimal WAV -> FLAC encoder against the public API of the PyTorch/CUDA
port (a port of ``examples/api_example.py``).

The canonical call sequence (reference analogue: util/api_example.c —
set defaults, validate, init, per-block encode, STREAMINFO rewrite),
expressed with the port's lifecycle. The encoder runs on the GPU unless
the caller asks for the CPU:

    python examples/api_example_torch.py in.wav out.flac [cuda|cpu]
"""

import sys

from flake_tpu_torch import Encoder, StreamConfig, set_defaults
from flake_tpu_torch import metadata
from flake_tpu_torch.io import open_pcm


def main(argv):
    if len(argv) not in (3, 4):
        print("usage: api_example_torch.py <input.wav> <output.flac> "
              "[cuda|cpu]")
        return 1
    infile, outfile = argv[1], argv[2]
    device = argv[3] if len(argv) == 4 else "cuda"

    with open(infile, "rb") as f:
        reader = open_pcm(f)
        info = reader.info

        # 1. parameters: level preset + stream description
        params = set_defaults(5)
        cfg = StreamConfig(channels=info.channels,
                           sample_rate=info.sample_rate,
                           bits_per_sample=info.bits_per_sample,
                           samples=info.samples, params=params)

        # 2. encoder init (validates params, like flake_encode_init)
        enc = Encoder(cfg, device=device)

        with open(outfile, "wb") as out:
            # 3. stream header
            out.write(enc.header())

            # 4. per-block encoding
            while True:
                pcm = reader.read_samples(params.block_size * 64)
                if pcm.shape[0] == 0:
                    break
                out.write(enc.encode(pcm))
            out.write(enc.finish())

            # 5. STREAMINFO rewrite with final MD5 / max frame size
            out.seek(8)
            out.write(metadata.write_streaminfo(enc.streaminfo()))

    print(f"encoded {infile} -> {outfile}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
