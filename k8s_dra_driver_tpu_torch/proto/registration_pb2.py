# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: registration.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x12registration.proto\x12\x12pluginregistration\"V\n\nPluginInfo\x12\x0c\n\x04type\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x10\n\x08\x65ndpoint\x18\x03 \x01(\t\x12\x1a\n\x12supported_versions\x18\x04 \x03(\t\">\n\x12RegistrationStatus\x12\x19\n\x11plugin_registered\x18\x01 \x01(\x08\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"\x1c\n\x1aRegistrationStatusResponse\"\r\n\x0bInfoRequest2\xd2\x01\n\x0cRegistration\x12L\n\x07GetInfo\x12\x1f.pluginregistration.InfoRequest\x1a\x1e.pluginregistration.PluginInfo\"\x00\x12t\n\x18NotifyRegistrationStatus\x12&.pluginregistration.RegistrationStatus\x1a..pluginregistration.RegistrationStatusResponse\"\x00\x42/Z-k8s.io/kubelet/pkg/apis/pluginregistration/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'registration_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'Z-k8s.io/kubelet/pkg/apis/pluginregistration/v1'
  _PLUGININFO._serialized_start=42
  _PLUGININFO._serialized_end=128
  _REGISTRATIONSTATUS._serialized_start=130
  _REGISTRATIONSTATUS._serialized_end=192
  _REGISTRATIONSTATUSRESPONSE._serialized_start=194
  _REGISTRATIONSTATUSRESPONSE._serialized_end=222
  _INFOREQUEST._serialized_start=224
  _INFOREQUEST._serialized_end=237
  _REGISTRATION._serialized_start=240
  _REGISTRATION._serialized_end=450
# @@protoc_insertion_point(module_scope)
