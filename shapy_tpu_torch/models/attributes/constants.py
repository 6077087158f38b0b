"""Attribute-model constants (port of
``shapy_tpu/models/attributes/constants.py``).

The 15 crowd-rated linguistic shape attributes per gender and the
self-report bias statistics (Spencer et al. 2002) used for noise-augmented
A2S training. Values match the reference's
``attributes/attributes/utils/constants.py:9-105`` — they are experimental
data, required verbatim for checkpoint / protocol parity.
"""

FEMALE_ATTRIBUTES = (
    "Big", "Broad Shoulders", "Feminine", "Large Breasts", "Long Legs",
    "Long Neck", "Long Torso", "Muscular", "Pear Shaped", "Petite",
    "Short", "Short Arms", "Skinny Legs", "Slim Waist", "Tall",
)

MALE_ATTRIBUTES = (
    "Average", "Big", "Broad Shoulders", "Delicate Build", "Long Legs",
    "Long Neck", "Long Torso", "Masculine", "Muscular", "Rectangular",
    "Short", "Short Arms", "Skinny Arms", "Soft Body", "Tall",
)

ATTRIBUTE_NAMES = {
    "female": list(FEMALE_ATTRIBUTES),
    "male": list(MALE_ATTRIBUTES),
}

# (magnitude, std) of the self-report error per Spencer et al. 2002:
# height is OVERestimated by ~0.60/1.23 cm and weight UNDERestimated by
# ~1.40/1.85 kg (women/men). Stored as positive magnitudes exactly like
# the reference (constants.py:7-18), whose noise augmentation uses only
# the std ([1]) for zero-mean noise (a2b.py:597-599) — apply your own
# sign if you ever consume the means.
SELF_REPORT_BIAS = {
    "female": {"weight": (1.40, 2.45), "height": (0.60, 2.68)},
    "male": {"weight": (1.85, 2.92), "height": (1.23, 2.57)},
}

NUM_ATTRIBUTES = 15
