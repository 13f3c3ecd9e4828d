from repro_torch.serving.requests import Request, RequestStatus  # noqa: F401
from repro_torch.serving.engine import ServeEngine  # noqa: F401
