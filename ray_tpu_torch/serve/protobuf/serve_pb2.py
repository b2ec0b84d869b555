# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: ray_tpu_torch/serve/protobuf/serve.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n(ray_tpu_torch/serve/protobuf/serve.proto\x12\x13ray_tpu_torch.serve"b\n\x0cServeRequest\x12\x13\n\x0bapplication\x18\x01 \x01(\t\x12\x0e\n\x06method\x18\x02 \x01(\t\x12\x1c\n\x14multiplexed_model_id\x18\x03 \x01(\t\x12\x0f\n\x07payload\x18\x04 \x01(\x0c"3\n\nServeReply\x12\x0f\n\x07payload\x18\x01 \x01(\x0c\x12\x14\n\x0ccontent_type\x18\x02 \x01(\t2\xbe\x01\n\x0fServeAPIService\x12O\n\x07Predict\x12!.ray_tpu_torch.serve.ServeRequest\x1a\x1f.ray_tpu_torch.serve.ServeReply"\x00\x12Z\n\x10PredictStreaming\x12!.ray_tpu_torch.serve.ServeRequest\x1a\x1f.ray_tpu_torch.serve.ServeReply"\x000\x01b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'serve_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SERVEREQUEST._serialized_start=65
  _SERVEREQUEST._serialized_end=163
  _SERVEREPLY._serialized_start=165
  _SERVEREPLY._serialized_end=216
  _SERVEAPISERVICE._serialized_start=219
  _SERVEAPISERVICE._serialized_end=409
# @@protoc_insertion_point(module_scope)
