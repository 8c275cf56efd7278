"""Launcher: ``python -m magellanmapper_torch [CLI arguments]`` starts the
command line of :mod:`magellanmapper_torch.io.cli` with uncaught
exceptions logged, as the reference's ``run.py`` does (the ``mm-torch``
script calls ``io.cli.main`` directly)."""

import logging
import sys


def main():
    logging.basicConfig(
        level=logging.INFO, format="%(levelname)s:%(name)s: %(message)s")

    def log_uncaught(exc_type, exc, tb):
        logging.getLogger("magellanmapper_torch").critical(
            "uncaught exception", exc_info=(exc_type, exc, tb))
        sys.__excepthook__(exc_type, exc, tb)

    sys.excepthook = log_uncaught
    from magellanmapper_torch.io import cli
    return cli.main()


if __name__ == "__main__":
    main()
