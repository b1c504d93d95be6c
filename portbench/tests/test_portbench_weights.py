"""The seeded serving weights: each heat head calibrated to as many peaks
above the serving threshold as the slide has blobs."""

import math

import pytest
import torch
import torch.nn.functional as F

from portbench import inputs, weights
from portbench.reference import model as reference_model
from portbench.reference import serve as reference_serve

CONFIG = {"family": "centerOffset", "num_layers": 10,
          "dims": [16, 16, 32, 64, 128, 64, 64, 64], "terminal_hidden": 32}
HEADS = {"heatmap.2": {"output": "heatmap", "std": 2.0,
                       "detections_per_blob": 1.0}}


@pytest.mark.parametrize("per_blob", [0.5, 1.0, 2.0])
def test_heat_head_has_a_peak_a_blob(per_blob):
    cpu = torch.device("cpu")
    gray = inputs.slide(600, 700, inputs.sub_seed(7, 2, 0))
    clips = torch.from_numpy(reference_serve.clips(gray))[:, None]
    model = reference_model.build(CONFIG)
    weights.fill(model, {"kind": "serve"}, 7, cpu)
    per_clip = inputs.blobs(600, 700) / len(clips)
    heads = {"heatmap.2": dict(HEADS["heatmap.2"],
                               detections_per_blob=per_blob)}
    weights.calibrate(model, heads, clips, per_clip)
    with torch.no_grad(), reference_model.float32_math():
        logits = model(clips)["heatmap"]
    heat = torch.sigmoid(logits)
    kept = heat == F.max_pool2d(heat, 3, 1, 1)
    above = int((kept & (heat > weights.SCORE_THRESHOLD)).sum())
    assert above == round(per_blob * per_clip * len(clips))
    assert math.isclose(float(logits.std()), 2.0, rel_tol=1e-3)
