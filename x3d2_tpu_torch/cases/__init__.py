from .base import BaseCase, SolverParams
from .cylinder import CylinderCase
from .generic import GenericCase
from .tgv import TGVCase
