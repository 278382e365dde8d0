"""Analytics applications from the paper (§5), built on the port's core.

Every app registers itself in the :mod:`repro_torch.apps.common` registry
— ``available_apps()`` / ``get_app(name)``.
"""

from .common import App, AppEngines, available_apps, get_app, register_app
from .ols import build_ols_program, OLS
from .matrix_powers import build_powers_program, MatrixPowers
from .sums_powers import build_sums_program, SumsOfPowers
from .general_iterative import build_general_program, GeneralIterative
from .pagerank import build_pagerank_program, PageRank
from .gradient_descent import build_bgd_program, BatchGradientDescent
from .fivm_learning import FivmLearning

for _name, _cls in (("ols", OLS), ("matrix_powers", MatrixPowers),
                    ("sums_powers", SumsOfPowers),
                    ("general_iterative", GeneralIterative),
                    ("pagerank", PageRank),
                    ("gradient_descent", BatchGradientDescent)):
    register_app(_name, _cls)
del _name, _cls

__all__ = [
    "App", "AppEngines", "available_apps", "get_app", "register_app",
    "build_ols_program", "OLS",
    "build_powers_program", "MatrixPowers",
    "build_sums_program", "SumsOfPowers",
    "build_general_program", "GeneralIterative",
    "build_pagerank_program", "PageRank",
    "build_bgd_program", "BatchGradientDescent",
    "FivmLearning",
]
