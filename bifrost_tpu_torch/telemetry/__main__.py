"""python -m bifrost_tpu_torch.telemetry [--enable|--disable|--status]
(counterpart of bifrost_tpu/telemetry/__main__.py)."""

import sys

from . import disable, enable, is_active


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    arg = argv[0] if argv else "--status"
    if arg == "--disable":
        disable()
        print("telemetry disabled")
    elif arg == "--enable":
        enable()
        print("telemetry enabled")
    elif arg == "--status":
        print(f"telemetry is {'active' if is_active() else 'disabled'}")
    else:
        print(f"usage: python -m bifrost_tpu_torch.telemetry "
              f"[--enable|--disable|--status] (got {arg!r})",
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
