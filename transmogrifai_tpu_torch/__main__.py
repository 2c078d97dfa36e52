"""``python -m transmogrifai_tpu_torch`` — the package's CLI (gen/serve/trace;
the same dispatch as ``python -m transmogrifai_tpu_torch.cli``)."""
import sys

from .cli.main import main

sys.exit(main())
