"""The traffic generator: reads a traffic file of ``traffic/`` and makes,
from the seed, what the cell's tenants send.

A training mix (``"loop": "closed"``) is one tenant that sends its next
step when the last one has returned: batches of ``batch`` images of the
configuration's digit pair, drawn from a pool of ``pool_batches`` distinct
batches made on the host in one vectorised call.  The batches stay on the
host, as the program's trainer keeps its training set, and each step
copies its own to the device.  Step k trains on pool batch k mod
``pool_batches``, so the first steps see rows that all differ, and every
seed sends the same sizes.
"""
from __future__ import annotations

import digits


class Feed:
    def __init__(self, traffic: dict, config: dict, seed: int):
        if traffic.get("loop") != "closed" or traffic.get("tenants", 1) != 1:
            raise NotImplementedError(
                f"traffic {traffic.get('name')!r}: only one closed-loop tenant is generated")
        self.batch, self.n = traffic["batch"], traffic["pool_batches"]
        a, b = config["digits"]
        x, y = digits.make_pairs(a, b, self.batch * self.n, seed,
                                 size=config["image_height"], noise=traffic["noise"])
        shape = (self.n, self.batch, config["image_height"], config["image_width"])
        self.images = digits.clean(x).reshape(shape)
        self.labels = y.reshape(self.n, self.batch)

    def __call__(self, k: int):
        """Pool batch k mod ``pool_batches``: images and labels, on the host."""
        return self.images[k % self.n], self.labels[k % self.n]
