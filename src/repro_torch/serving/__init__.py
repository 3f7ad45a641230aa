from repro_torch.serving.request import Request, RequestState, SamplingParams  # noqa: F401
