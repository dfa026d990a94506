"""``python -m allegro_tpu_torch {train,test,run,md} -c <config>``: see ``cli.py``."""

import sys

from .cli import main

sys.exit(main())
