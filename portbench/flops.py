"""Forward operations of a configuration, counted from its layer shapes.

A convolution counts ``2 k^2 C_in C_out H_out W_out``; a transposed
convolution ``2 k^2 C_in C_out H_in W_in``, the products it needs (the
count ``torch.utils.flop_counter`` makes). Nothing else is counted:
BatchNorm, activations, pools and the decode are left out. The shapes
come from the configuration's family (``reference/<family>.py``'s
``layers``), so the count is of the work a clip needs, whatever
implements it, and no change to the system under test can move it.
"""

from __future__ import annotations

from typing import Dict

from portbench.reference.model import layers


def forward_per_clip(config: Dict, size: int) -> int:
    """Forward operations of one ``size``-square clip."""
    return sum(2 * k * k * cin * cout * h * w
               for k, cin, cout, h, w in layers(config, size))
