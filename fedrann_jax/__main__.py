import sys

from fedrann_jax.cli import main

sys.exit(main())
