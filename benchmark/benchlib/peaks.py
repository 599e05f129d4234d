"""The peaks that roofline shares are taken against: one NVIDIA H100 SXM
(NVIDIA's data sheet, at its full 700 W power limit; a result names the
card's own limit beside its shares)."""

HBM_BYTES_PER_S = 3.35e12   # device memory, 80 GB of HBM3
F32_OPS_PER_S = 67e12       # float32 outside the tensor cores, a fused
#                             multiply-add counted as two operations
# No operation of the carve may fuse into a multiply-add (each multiply
# and add of the DCT chains is rounded on its own; the DP's adds and
# minimums have nothing to fuse with), so each takes an instruction slot
# of its own: half the multiply-add rate.
F32_UNFUSED_OPS_PER_S = F32_OPS_PER_S / 2
