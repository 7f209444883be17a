"""Device milliseconds per step of everything that is not a hand-written
contact, moment or FTCS kernel (B6, B1/B2/B3, B4, B5): the sorts and plan,
the predicated window rebuild, the biology's elementwise operations, the
draws, the deposit, the update and the FMAs. Layer: step glue."""

# the profiler's names of the kernels that are not glue
NOT_GLUE = ("contact_substep_kernel", "contact_mask_kernel", "mask_compact_kernel",
            "bio_moments_kernel", "ftcs_diffuse_kernel")


def read(run):
    if run.trace is None or run.traced_steps == 0 or not run.trace.op_s:
        return None
    glue = sum(s for name, s in run.trace.op_s.items()
               if not any(k in name for k in NOT_GLUE))
    return glue / run.traced_steps * 1e3
