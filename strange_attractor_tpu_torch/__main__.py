"""``python -m strange_attractor_tpu_torch`` entry point."""

from .cli import main

raise SystemExit(main())
