from .compact import CompactOp, apply_matrix, build_op
from .dirops import AxisOps, build_all_ops, build_axis_ops
