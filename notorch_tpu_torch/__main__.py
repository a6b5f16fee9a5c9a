"""``python -m notorch_tpu_torch predict ...`` -> the predict CLI."""

import sys

COMMANDS = ("predict",)


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        raise SystemExit(
            f"usage: python -m notorch_tpu_torch {{{','.join(COMMANDS)}}} ... "
            "(training comes with a later slice)"
        )
    from notorch_tpu_torch.cli.predict import main as predict_main

    predict_main(argv[1:])


if __name__ == "__main__":
    main()
