import sys

from ray_tpu_torch.chaos.runner import main

sys.exit(main())
