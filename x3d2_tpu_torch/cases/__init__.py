from .base import BaseCase, SolverParams
from .channel import ChannelCase
from .cylinder import CylinderCase
from .generic import GenericCase
from .tgv import TGVCase
