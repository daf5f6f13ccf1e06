"""Distribution: ring collectives, parameter placement and the TP seams,
on ``torch.distributed`` (one process per rank).

``collectives`` ring reduce-scatter / all-gather / all-reduce with
                optional takum wire compression (the codec kernels on
                CUDA tensors) and error-feedback residuals;
``sharding``    the logical-axis rules and the FSDP x TP parameter
                placement (``param_spec``);
``tp``          the serving step's tensor-parallel seams
                (``attn_out``, ``mlp_out``, ``unembed_rows``);
``selftest``    ``python -m repro_torch.dist.selftest --world N``: N gloo
                ranks on the CPU run the reference's checks.
"""

from repro_torch.dist import collectives, sharding  # noqa: F401
