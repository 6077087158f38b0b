"""OpenPose tracked-sequence dataset (port of
``shapy_tpu/data/datasets/openpose_tracks.py``).

Behavioural spec: reference ``regressor/human_shape/data/datasets/
openpose.py:249-459`` (OpenPoseTracks): like the OpenPose demo dataset
but with per-person track IDs so a person keeps a consistent identity
across frames — items carry (track_id, frame_idx) and the loader can
group by track for temporal smoothing/visualisation.

Expected layout: ``<data_folder>/<img_folder>`` frames +
``<data_folder>/<keyp_folder>/<frame>_keypoints.json`` with OpenPose
``person_id`` fields (or positional fallback).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from shapy_tpu_torch.data.datasets.openpose import OpenPoseDataset


class OpenPoseTracksDataset(OpenPoseDataset):
    def __init__(self, *args, **kwargs):
        # Defer to the base loader, then recover track ids per item.
        super().__init__(*args, **kwargs)
        self.track_ids: List[int] = []
        counts: Dict[str, int] = {}
        for path in self.img_paths:
            fname = os.path.splitext(os.path.basename(path))[0]
            keyp_path = os.path.join(self.keyp_folder,
                                     f"{fname}_keypoints.json")
            if not os.path.exists(keyp_path):
                keyp_path = os.path.join(self.keyp_folder, f"{fname}.json")
            idx_in_img = counts.get(path, 0)
            counts[path] = idx_in_img + 1
            track = idx_in_img
            try:
                with open(keyp_path) as f:
                    people = json.load(f).get("people", [])
                pid = people[idx_in_img].get("person_id")
                if isinstance(pid, list):
                    pid = pid[0] if pid else -1
                if pid is not None and int(pid) >= 0:
                    track = int(pid)
            except (OSError, IndexError, ValueError, KeyError):
                pass
            self.track_ids.append(track)

    def __getitem__(self, index: int) -> Optional[Dict]:
        sample = super().__getitem__(index)
        if sample is not None:
            sample["track_id"] = self.track_ids[index]
        return sample

    def tracks(self) -> Dict[int, List[int]]:
        """track_id -> sorted item indices."""
        out: Dict[int, List[int]] = {}
        for i, t in enumerate(self.track_ids):
            out.setdefault(t, []).append(i)
        return out
