"""The paper's workload suites, the training token stream and the byte
tokenizer (host-side, numpy)."""
from repro_torch.data.tokenizer import ByteTokenizer  # noqa: F401
from repro_torch.data.workloads import (  # noqa: F401
    WORKLOADS,
    TokenStream,
    WorkloadProfile,
    make_workload,
    sample_mixed,
    sample_requests,
)
