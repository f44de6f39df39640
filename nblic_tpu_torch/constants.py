"""Constants of the NBLIC format family that the port uses.

The port's own copy of the values in ``nblic_tpu/constants.py`` (the pixel
range and the effort-0 / NBTC model constants), so that it imports nothing
of the JAX package.
"""

MAX_VAL = 255
MID_VAL = (MAX_VAL + 1) // 2

# ---- effort-0 (NBTC) model constants ----
Q_N_QD = 12
Q_N_CONTEXT = Q_N_QD * 256         # 3072 context-bias cells
# weight-LUT thresholds and activity thresholds
Q_PT_THRESH = (5, 12, 34, 78, 194, 431, 601, 608)
Q_QD_THRESH = (1, 2, 4, 6, 9, 15, 25, 39, 63, 101, 151, 152)

# profile-3 dual-bin activity quantizer mid-points
Q_MID = (0, 2, 4, 7, 10, 14, 20, 26, 34, 42, 52, 64, 78, 95, 135, 200)
