"""Receding-horizon controller, moving-horizon estimator and costs."""
from gpmpc_tpu_torch.mpc.controller import MPC
from gpmpc_tpu_torch.mpc.mhe import MHE
from gpmpc_tpu_torch.mpc.output_feedback import (OutputFeedbackResult,
                                                 simulate_output_feedback)

__all__ = ["MPC", "MHE", "simulate_output_feedback",
           "OutputFeedbackResult"]
