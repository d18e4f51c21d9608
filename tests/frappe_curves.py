"""Early Frappe curves of the JAX package and the port from one
initialisation, on the CPU:

    JAX_PLATFORMS=cpu python tests/frappe_curves.py [--epochs 2]
        [--seeds 2025 1 42] [--out curves.json]

tests/preset_curves.py with the frappe_armnet1h recipe (armnet_1h, alpha 2,
h 128, lr 0.001, batch 4096, dropout 0): for each seed the JAX trainer's
curve from its own init, the port's from that init and the port's from its
own init at the same seed. Prints one JSON object: the valid AUC per epoch
of every run.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from preset_curves import main  # noqa: E402

if __name__ == "__main__":
    main(["--preset", "frappe_armnet1h", *sys.argv[1:]])
