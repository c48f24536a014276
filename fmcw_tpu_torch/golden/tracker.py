"""Track status codes of the TWS tracker (rtl/src/tws_tracker.vhd), copied
from ``fmcw_tpu/golden/tracker.py``."""

FREE, TENTATIVE, FIRM, COAST = 0, 1, 2, 3
