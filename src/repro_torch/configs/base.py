"""The paper's FitGpp defaults (§4.3), single source for the port."""
PAPER_S = 4.0       # Eq. 3 grace-period weight s
PAPER_P = 1         # per-job preemption cap P (Fig. 5 sweeps it)
