from .base import BaseCase, SolverParams
from .tgv import TGVCase
