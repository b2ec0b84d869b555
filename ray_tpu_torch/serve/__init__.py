"""ray_tpu_torch.serve: online model serving on the ray_tpu_torch runtime.

Same capability surface as the reference's Ray Serve (python/ray/serve):
deployments with replica autoscaling, an HTTP proxy with pow-2 routing, model
composition via deployment handles, and a reconciling controller actor.

    from ray_tpu_torch import serve

    @serve.deployment(num_replicas=2)
    class Model:
        def __call__(self, x):
            return x * 2

    handle = serve.run(Model.bind())
    assert handle.remote(2).result() == 4
"""

from ray_tpu_torch.serve._private.common import DeploymentOverloadedError
from ray_tpu_torch.serve._private.proxy import HTTPRequest
from ray_tpu_torch.serve.api import (
    Application,
    Deployment,
    delete,
    deployment,
    get_app_handle,
    get_deployment_handle,
    get_multiplexed_model_id,
    ingress,
    multiplexed,
    run,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.schema import AutoscalingConfig, DeploymentConfig, HTTPOptions

__all__ = [
    "Application",
    "AutoscalingConfig",
    "Deployment",
    "DeploymentConfig",
    "DeploymentHandle",
    "DeploymentOverloadedError",
    "DeploymentResponse",
    "HTTPOptions",
    "HTTPRequest",
    "delete",
    "deployment",
    "get_app_handle",
    "get_deployment_handle",
    "get_multiplexed_model_id",
    "ingress",
    "multiplexed",
    "run",
    "shutdown",
    "start",
    "status",
]
