# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: dra.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\tdra.proto\x12\x08v1alpha3\"5\n\x05\x43laim\x12\x0b\n\x03uid\x18\x01 \x01(\t\x12\x11\n\tnamespace\x18\x02 \x01(\t\x12\x0c\n\x04name\x18\x03 \x01(\t\">\n\x1bNodePrepareResourcesRequest\x12\x1f\n\x06\x63laims\x18\x01 \x03(\x0b\x32\x0f.v1alpha3.Claim\"_\n\x06\x44\x65vice\x12\x15\n\rrequest_names\x18\x01 \x03(\t\x12\x11\n\tpool_name\x18\x02 \x01(\t\x12\x13\n\x0b\x64\x65vice_name\x18\x03 \x01(\t\x12\x16\n\x0e\x63\x64i_device_ids\x18\x04 \x03(\t\"O\n\x1bNodePrepareResourceResponse\x12!\n\x07\x64\x65vices\x18\x01 \x03(\x0b\x32\x10.v1alpha3.Device\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"\xb8\x01\n\x1cNodePrepareResourcesResponse\x12\x42\n\x06\x63laims\x18\x01 \x03(\x0b\x32\x32.v1alpha3.NodePrepareResourcesResponse.ClaimsEntry\x1aT\n\x0b\x43laimsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x34\n\x05value\x18\x02 \x01(\x0b\x32%.v1alpha3.NodePrepareResourceResponse:\x02\x38\x01\"@\n\x1dNodeUnprepareResourcesRequest\x12\x1f\n\x06\x63laims\x18\x01 \x03(\x0b\x32\x0f.v1alpha3.Claim\".\n\x1dNodeUnprepareResourceResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"\xbe\x01\n\x1eNodeUnprepareResourcesResponse\x12\x44\n\x06\x63laims\x18\x01 \x03(\x0b\x32\x34.v1alpha3.NodeUnprepareResourcesResponse.ClaimsEntry\x1aV\n\x0b\x43laimsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x36\n\x05value\x18\x02 \x01(\x0b\x32\'.v1alpha3.NodeUnprepareResourceResponse:\x02\x38\x01\x32\xe3\x01\n\tDRAPlugin\x12g\n\x14NodePrepareResources\x12%.v1alpha3.NodePrepareResourcesRequest\x1a&.v1alpha3.NodePrepareResourcesResponse\"\x00\x12m\n\x16NodeUnprepareResources\x12\'.v1alpha3.NodeUnprepareResourcesRequest\x1a(.v1alpha3.NodeUnprepareResourcesResponse\"\x00\x42&Z$k8s.io/kubelet/pkg/apis/dra/v1alpha4b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'dra_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'Z$k8s.io/kubelet/pkg/apis/dra/v1alpha4'
  _NODEPREPARERESOURCESRESPONSE_CLAIMSENTRY._options = None
  _NODEPREPARERESOURCESRESPONSE_CLAIMSENTRY._serialized_options = b'8\001'
  _NODEUNPREPARERESOURCESRESPONSE_CLAIMSENTRY._options = None
  _NODEUNPREPARERESOURCESRESPONSE_CLAIMSENTRY._serialized_options = b'8\001'
  _CLAIM._serialized_start=23
  _CLAIM._serialized_end=76
  _NODEPREPARERESOURCESREQUEST._serialized_start=78
  _NODEPREPARERESOURCESREQUEST._serialized_end=140
  _DEVICE._serialized_start=142
  _DEVICE._serialized_end=237
  _NODEPREPARERESOURCERESPONSE._serialized_start=239
  _NODEPREPARERESOURCERESPONSE._serialized_end=318
  _NODEPREPARERESOURCESRESPONSE._serialized_start=321
  _NODEPREPARERESOURCESRESPONSE._serialized_end=505
  _NODEPREPARERESOURCESRESPONSE_CLAIMSENTRY._serialized_start=421
  _NODEPREPARERESOURCESRESPONSE_CLAIMSENTRY._serialized_end=505
  _NODEUNPREPARERESOURCESREQUEST._serialized_start=507
  _NODEUNPREPARERESOURCESREQUEST._serialized_end=571
  _NODEUNPREPARERESOURCERESPONSE._serialized_start=573
  _NODEUNPREPARERESOURCERESPONSE._serialized_end=619
  _NODEUNPREPARERESOURCESRESPONSE._serialized_start=622
  _NODEUNPREPARERESOURCESRESPONSE._serialized_end=812
  _NODEUNPREPARERESOURCESRESPONSE_CLAIMSENTRY._serialized_start=726
  _NODEUNPREPARERESOURCESRESPONSE_CLAIMSENTRY._serialized_end=812
  _DRAPLUGIN._serialized_start=815
  _DRAPLUGIN._serialized_end=1042
# @@protoc_insertion_point(module_scope)
