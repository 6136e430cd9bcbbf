from .base import BaseCase, SolverParams
from .cylinder import CylinderCase
from .tgv import TGVCase
