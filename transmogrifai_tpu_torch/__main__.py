"""``python -m transmogrifai_tpu_torch`` — the package's CLI (gen/serve;
the same dispatch as ``python -m transmogrifai_tpu_torch.cli``)."""
import sys

from .cli.main import main

sys.exit(main())
