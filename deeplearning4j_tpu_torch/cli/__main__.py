import sys

from .driver import main

if __name__ == "__main__":  # `python -m deeplearning4j_tpu_torch.cli`
    sys.exit(main())
