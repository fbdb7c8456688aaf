"""The dense GQA + RoPE + qk-norm estimator backbone."""
