"""Command dispatcher: ``python -m mixermdm_tpu_torch <command> ...``."""

import importlib
import sys

COMMANDS = {
    "infer-mixermdm": ("mixermdm_tpu_torch.cli.infer_mixermdm", "MixerMDM inference"),
    "infer-in2in": ("mixermdm_tpu_torch.cli.infer_in2in",
                    "in2IN inference (interaction / individual / dual = DualMDM)"),
    "infer-mdm": ("mixermdm_tpu_torch.cli.infer_mdm", "MDM single-person inference"),
    "train-mixermdm": ("mixermdm_tpu_torch.cli.train_mixermdm", "MixerMDM adversarial training"),
    "train-in2in": ("mixermdm_tpu_torch.cli.train_in2in",
                    "base-model training (in2IN interaction / individual, MDM)"),
    "train-finetuned": ("mixermdm_tpu_torch.cli.train_finetuned",
                        "fine-tune an interaction in2IN model from an individual one"),
    "eval-mixermdm": ("mixermdm_tpu_torch.cli.eval_mixermdm",
                      "MixerMDM evaluation (dual-dataset protocol + F-score)"),
    "eval-base": ("mixermdm_tpu_torch.cli.eval_base",
                  "base-model evaluation (in2IN / DualMDM / MDM)"),
    "train-evaluator": ("mixermdm_tpu_torch.cli.train_evaluator",
                        "train the InterCLIP evaluator"),
    "serve": ("mixermdm_tpu_torch.cli.serve", "HTTP generation server (continuous batching)"),
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
