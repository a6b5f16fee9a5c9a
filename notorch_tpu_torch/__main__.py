"""``python -m notorch_tpu_torch {train,predict} ...`` -> the train or predict CLI."""

import sys

COMMANDS = ("train", "predict")


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        raise SystemExit(f"usage: python -m notorch_tpu_torch {{{','.join(COMMANDS)}}} ...")
    if argv[0] == "train":
        from notorch_tpu_torch.cli.train import main as command
    else:
        from notorch_tpu_torch.cli.predict import main as command
    command(argv[1:])


if __name__ == "__main__":
    main()
