"""Hand-written gRPC service glue for the generated _pb2 modules.

(grpcio-tools is not part of the runtime environment, so the servicer /
stub classes normally emitted into *_pb2_grpc.py are written out by hand
against the same method paths and serializers.)
"""

from __future__ import annotations

import grpc

from . import dra_pb2, registration_pb2

DRA_SERVICE = "v1alpha3.DRAPlugin"
REGISTRATION_SERVICE = "pluginregistration.Registration"


class DRAPluginServicer:
    """Service interface for the DRA plugin (NodeServer analog)."""

    def NodePrepareResources(self, request, context):
        raise NotImplementedError

    def NodeUnprepareResources(self, request, context):
        raise NotImplementedError


def add_dra_servicer(servicer: DRAPluginServicer, server: grpc.Server) -> None:
    handlers = {
        "NodePrepareResources": grpc.unary_unary_rpc_method_handler(
            servicer.NodePrepareResources,
            request_deserializer=dra_pb2.NodePrepareResourcesRequest.FromString,
            response_serializer=dra_pb2.NodePrepareResourcesResponse
            .SerializeToString),
        "NodeUnprepareResources": grpc.unary_unary_rpc_method_handler(
            servicer.NodeUnprepareResources,
            request_deserializer=dra_pb2.NodeUnprepareResourcesRequest
            .FromString,
            response_serializer=dra_pb2.NodeUnprepareResourcesResponse
            .SerializeToString),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(DRA_SERVICE, handlers),))


class DRAPluginStub:
    def __init__(self, channel: grpc.Channel):
        self.NodePrepareResources = channel.unary_unary(
            f"/{DRA_SERVICE}/NodePrepareResources",
            request_serializer=dra_pb2.NodePrepareResourcesRequest
            .SerializeToString,
            response_deserializer=dra_pb2.NodePrepareResourcesResponse
            .FromString)
        self.NodeUnprepareResources = channel.unary_unary(
            f"/{DRA_SERVICE}/NodeUnprepareResources",
            request_serializer=dra_pb2.NodeUnprepareResourcesRequest
            .SerializeToString,
            response_deserializer=dra_pb2.NodeUnprepareResourcesResponse
            .FromString)


class RegistrationServicer:
    """Kubelet plugin-registration service interface."""

    def GetInfo(self, request, context):
        raise NotImplementedError

    def NotifyRegistrationStatus(self, request, context):
        raise NotImplementedError


def add_registration_servicer(servicer: RegistrationServicer,
                              server: grpc.Server) -> None:
    handlers = {
        "GetInfo": grpc.unary_unary_rpc_method_handler(
            servicer.GetInfo,
            request_deserializer=registration_pb2.InfoRequest.FromString,
            response_serializer=registration_pb2.PluginInfo.SerializeToString),
        "NotifyRegistrationStatus": grpc.unary_unary_rpc_method_handler(
            servicer.NotifyRegistrationStatus,
            request_deserializer=registration_pb2.RegistrationStatus
            .FromString,
            response_serializer=registration_pb2.RegistrationStatusResponse
            .SerializeToString),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(REGISTRATION_SERVICE,
                                              handlers),))


class RegistrationStub:
    def __init__(self, channel: grpc.Channel):
        self.GetInfo = channel.unary_unary(
            f"/{REGISTRATION_SERVICE}/GetInfo",
            request_serializer=registration_pb2.InfoRequest.SerializeToString,
            response_deserializer=registration_pb2.PluginInfo.FromString)
        self.NotifyRegistrationStatus = channel.unary_unary(
            f"/{REGISTRATION_SERVICE}/NotifyRegistrationStatus",
            request_serializer=registration_pb2.RegistrationStatus
            .SerializeToString,
            response_deserializer=registration_pb2.RegistrationStatusResponse
            .FromString)
