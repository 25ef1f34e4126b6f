"""The JAX package's dry run (``src/repro/launch/dryrun.py:run_cell``) of
some cells on the 16 x 16 mesh of 256 host devices: XLA's
``argument_size_in_bytes`` of each, or the error it raises, as one JSON
line ``{"<arch> <shape>": bytes or message}``.

``tests/test_torch_dryrun.py`` runs it on its four cells.  With
``--decode`` it runs all twenty decode cells instead (a few minutes on a
CPU) and also prints each beside the port's count
(``repro_torch.launch.dryrun``):

    PYTHONPATH=src JAX_PLATFORMS=cpu \\
    XLA_FLAGS=--xla_force_host_platform_device_count=256 \\
        python tests/_torch_dryrun_reference.py [--decode]
"""
import json
import sys

import jax

# The cells the test holds: two decode cells that compile, and a train and
# a prefill cell that fail on jax 0.9.0.
CELLS = (("gemma3-1b", "decode_32k"), ("whisper-tiny", "decode_32k"),
         ("whisper-tiny", "train_4k"), ("xlstm-350m", "prefill_32k"))


def main(argv) -> int:
    # before the reference's dryrun, whose import asks for 512 devices
    assert len(jax.devices()) == 256, len(jax.devices())
    from repro.configs import ARCH_NAMES
    from repro.launch import dryrun

    decode = "--decode" in argv
    cells = ([(a, s) for s in ("decode_32k", "long_500k")
              for a in ARCH_NAMES] if decode else CELLS)
    out = {}
    for arch, shape in cells:
        try:
            rec = dryrun.run_cell(arch, shape, False, save=False,
                                  verbose=False)
            out[f"{arch} {shape}"] = rec["memory"]["argument_size_in_bytes"]
        except ValueError as e:
            out[f"{arch} {shape}"] = str(e)
    if decode:
        from repro_torch.launch import dryrun as port

        for arch, shape in cells:
            got = port.run_cell(arch, shape, False, save=False,
                                verbose=False)["memory"]
            print(f"{arch} {shape}: XLA {out[f'{arch} {shape}']}, port "
                  f"{got['argument_size_in_bytes']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
