"""A gang follower process: ``python -m tpu_task_torch.ml.parallel.follower
'<spec json>'``, started by :func:`tpu_task_torch.ml.parallel.gang.start`.
A module of its own so that the follower imports only the port, never the
module that started it."""

from __future__ import annotations

import json
import sys

from tpu_task_torch.ml.parallel.gang import follower_main

if __name__ == "__main__":
    sys.exit(follower_main(json.loads(sys.argv[1])))
