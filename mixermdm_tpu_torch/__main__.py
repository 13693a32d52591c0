"""Command dispatcher: ``python -m mixermdm_tpu_torch <command> ...``."""

import importlib
import sys

COMMANDS = {
    "infer-mixermdm": ("mixermdm_tpu_torch.cli.infer_mixermdm", "MixerMDM inference"),
    "train-mixermdm": ("mixermdm_tpu_torch.cli.train_mixermdm", "MixerMDM adversarial training"),
}


def main():
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print("usage: python -m mixermdm_tpu_torch <command> [args...]\n\ncommands:")
        for name, (_, desc) in COMMANDS.items():
            print(f"  {name:18s} {desc}")
        return 0 if len(sys.argv) >= 2 else 1
    cmd = sys.argv[1]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; try --help")
        return 1
    return importlib.import_module(COMMANDS[cmd][0]).main(sys.argv[2:])


if __name__ == "__main__":
    sys.exit(main() or 0)
