"""Constants of the NBLIC format family that the port uses.

The port's own copy of the values in ``nblic_tpu/constants.py`` (the pixel
range, the mode surface, the effort-0 / NBTC and the effort-1..3 model
constants), so that it imports nothing of the JAX package.
"""

MAX_VAL = 255
MID_VAL = (MAX_VAL + 1) // 2

# ---- mode surface ----
MAX_NEAR = MAX_VAL // 26          # = 9
EFFORTS = (0, 1, 2, 3)            # 0 => the Q0.2 engine, 1..3 => NBLIC0.3
MIN_K_STEP = 3

# ---- NBLIC0.3 (effort 1-3) model constants ----
N_QD = 16                          # activity bins
N_CONTEXT = (N_QD >> 1) * 256      # 2048 context-bias cells
MAX_PX_INC = MAX_VAL - MID_VAL     # 127

# ---- effort-0 (NBTC) model constants ----
Q_N_QD = 12
Q_N_CONTEXT = Q_N_QD * 256         # 3072 context-bias cells
# weight-LUT thresholds and activity thresholds
Q_PT_THRESH = (5, 12, 34, 78, 194, 431, 601, 608)
Q_QD_THRESH = (1, 2, 4, 6, 9, 15, 25, 39, 63, 101, 151, 152)

# NBLIC0.3 blend-weight thresholds over the cost sum; MAX_VAL // 8 == 31
_T = MAX_VAL // 8
C_THRESHOLDS = (1 * _T, 3 * _T, 9 * _T, 20 * _T, 50 * _T, 110 * _T, 300 * _T, 800 * _T)

# dual-bin activity quantizer mid-points (NBLIC0.3 and profile 3)
Q_MID = (0, 2, 4, 7, 10, 14, 20, 26, 34, 42, 52, 64, 78, 95, 135, 200)
