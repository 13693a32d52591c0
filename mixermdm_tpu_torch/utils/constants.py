"""Skeleton / motion-representation constants (the subset the sampling path
and the training data read), copied from ``mixermdm_tpu/utils/constants.py``.

The 262-d InterHuman feature layout::

    [ 0:66)    22 joint xyz positions
    [66:132)   22 joint xyz velocities
    [132:258)  21 joint 6d rotations
    [258:262)  4 foot-contact labels
"""

NUM_JOINTS = 22
NUM_ROT_JOINTS = 21
FEATS_DIM = 262          # 66 + 66 + 126 + 4

# Face direction joints: r_hip, l_hip, sdr_r, sdr_l
FACE_JOINT_INDX = (2, 1, 17, 16)

# Foot joints for contact detection: (ankle, toe) right and left.
FID_R = (8, 11)
FID_L = (7, 10)

# Default sampling window.
INFER_WINDOW = 299
