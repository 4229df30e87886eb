"""The pipeline's point-to-point layer (:mod:`.p2p_communication`)."""
from . import p2p_communication
from .p2p_communication import P2PCommunicator, decode_meta, encode_meta

__all__ = ["p2p_communication", "P2PCommunicator", "encode_meta",
           "decode_meta"]
