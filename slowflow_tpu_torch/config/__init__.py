"""The reference's tab-separated .cfg parameter lists."""
from .params import ParameterList, Verbosity
