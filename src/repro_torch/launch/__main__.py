"""One front door for the port's launchers: ``python -m repro_torch <subcommand>``.

    python -m repro_torch serve --arch yi-6b --preset full   # on the card
    python -m repro_torch serve --preset small --device cpu  # on the CPU
    python -m repro_torch tune --arch yi-6b                  # three tuners, on the card
    python -m repro_torch tune --device cpu --backend sim    # on the CPU
    python -m repro_torch tune --skip kernel --refit-demo    # ds-array + mesh
    python -m repro_torch train --preset small --use-flash   # trainer, on the card
    python -m repro_torch train --preset small --device cpu  # on the CPU
    python -m repro_torch train --preset small --device cpu --host-devices 4 \
        --inject-failure 6                                  # 4 gloo ranks, re-mesh
    python -m repro_torch mesh                               # describe the mesh
    python -m repro_torch mesh --device cpu --host-devices 4
    python -m repro_torch evaluate --smoke                   # paper protocol, on the card
    python -m repro_torch evaluate --smoke --device cpu      # on the CPU
    python -m repro_torch serve-estimator --demo             # serving tier, sweep on the card
    python -m repro_torch serve-estimator --demo --device cpu

Each subcommand resolves to the matching ``repro_torch.launch.<module>``
main, which parses ``sys.argv`` as rewritten here.
"""
from __future__ import annotations

import importlib
import sys

# subcommand -> (module, one-line help)
COMMANDS = {
    "serve": ("repro_torch.launch.serve",
              "batched prefill+decode serving driver"),
    "tune": ("repro_torch.launch.tune",
             "the three tuner families: ds-array block sizes, kernel "
             "tiles, mesh"),
    "train": ("repro_torch.launch.train",
              "training launcher on a mesh with checkpoints, failure "
              "injection and elastic re-mesh"),
    "mesh": ("repro_torch.launch.mesh",
             "construct and describe a device mesh"),
    "evaluate": ("repro_torch.launch.evaluate",
                 "paper evaluation protocol (speedup vs default blocks) "
                 "and the closed loop"),
    "serve-estimator": ("repro_torch.launch.serve_estimator",
                        "online serving tier: warm, serve a trace, report"),
}


def _usage(out=None) -> None:
    out = out or sys.stdout
    print("usage: python -m repro_torch <subcommand> [args...]\n", file=out)
    print("subcommands:", file=out)
    for name, (_mod, desc) in COMMANDS.items():
        print(f"  {name:<16} {desc}", file=out)
    print("\n`python -m repro_torch <subcommand> --help` shows that "
          "launcher's flags.", file=out)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        _usage()
        return 0
    if argv[0] not in COMMANDS:
        print(f"python -m repro_torch: unknown subcommand {argv[0]!r}",
              file=sys.stderr)
        _usage(sys.stderr)
        return 2
    module, _desc = COMMANDS[argv[0]]
    sys.argv = [f"python -m repro_torch {argv[0]}"] + argv[1:]
    importlib.import_module(module).main()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
