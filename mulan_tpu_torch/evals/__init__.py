"""Evaluation: sparse and dense VLB, exact NLL through the probability-flow
ODE and the ODE sampler, checkpoint evaluation and ancestral sampling."""

from mulan_tpu_torch.evals.nll_ode import (eval_bpd_ode,
                                           make_ode_likelihood_fn,
                                           make_ode_sample_fn)
from mulan_tpu_torch.evals.vlb import eval_bpd_dense, eval_bpd_sparse

__all__ = ['eval_bpd_sparse', 'eval_bpd_dense', 'eval_bpd_ode',
           'make_ode_likelihood_fn', 'make_ode_sample_fn']
