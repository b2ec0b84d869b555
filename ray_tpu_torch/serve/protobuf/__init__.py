"""Generated + hand-rolled gRPC bindings for the typed Serve ingress
(reference: src/ray/protobuf/serve.proto RayServeAPIService).

serve_pb2 is generated by protoc (see serve.proto header). The service
stubs are assembled here with grpc's generic handler API — equivalent to
grpc_tools output, which is not available in this environment.
"""

from ray_tpu_torch.serve.protobuf.serve_pb2 import ServeReply, ServeRequest

SERVICE_NAME = "ray_tpu_torch.serve.ServeAPIService"


def add_serve_api_servicer(server, predict, predict_streaming):
    """Register the typed service on a grpc.aio server.

    predict: async (ServeRequest, context) -> ServeReply
    predict_streaming: async generator (ServeRequest, context) -> ServeReply
    """
    import grpc

    handler = grpc.method_handlers_generic_handler(
        SERVICE_NAME,
        {
            "Predict": grpc.unary_unary_rpc_method_handler(
                predict,
                request_deserializer=ServeRequest.FromString,
                response_serializer=ServeReply.SerializeToString,
            ),
            "PredictStreaming": grpc.unary_stream_rpc_method_handler(
                predict_streaming,
                request_deserializer=ServeRequest.FromString,
                response_serializer=ServeReply.SerializeToString,
            ),
        },
    )
    server.add_generic_rpc_handlers((handler,))


class ServeAPIStub:
    """Typed client stub (what grpc_tools would have generated)."""

    def __init__(self, channel):
        self.Predict = channel.unary_unary(
            f"/{SERVICE_NAME}/Predict",
            request_serializer=ServeRequest.SerializeToString,
            response_deserializer=ServeReply.FromString,
        )
        self.PredictStreaming = channel.unary_stream(
            f"/{SERVICE_NAME}/PredictStreaming",
            request_serializer=ServeRequest.SerializeToString,
            response_deserializer=ServeReply.FromString,
        )
