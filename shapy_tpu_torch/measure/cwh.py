"""Chest / waist / hips only (port of ``shapy_tpu/measure/cwh.py``): the
circumference-only variant of :class:`BodyMeasurements`, for when no
height or mass is supervised."""

from __future__ import annotations

from typing import Dict

from shapy_tpu_torch.measure.measurements import BodyMeasurements


class ChestWaistHipsMeasurements(BodyMeasurements):
    def forward(self, triangles, **kwargs) -> Dict:
        return {"measurements": self.compute_peripheries(
            triangles,
            compute_chest=kwargs.get("compute_chest", True),
            compute_waist=kwargs.get("compute_waist", True),
            compute_hips=kwargs.get("compute_hips", True))}
