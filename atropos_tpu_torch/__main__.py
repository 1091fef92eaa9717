"""``python -m atropos_tpu_torch`` entry point."""
import sys

from atropos_tpu_torch.commands import execute_cli


def main(argv=None, device=None):
    """Run one command line and return its exit code.

    ``device`` (``'cuda'``, ``'cpu'`` or None) overrides a ``--device``
    option in ``argv``; with neither, the run is on ``cuda`` and raises
    when no card is usable.
    """
    if argv is None:
        argv = sys.argv[1:]
    return execute_cli(argv, device=device)


if __name__ == "__main__":
    sys.exit(main())
