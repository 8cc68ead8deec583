"""The port runs on the card unless the caller asks for the CPU.

* every model constructor's ``device`` defaults to "cuda";
* each program, run without ``--device`` where no card is present, exits
  non-zero with a message naming ``--device cpu``, before it builds a
  model; ``--device cpu`` still solves.
"""

import inspect

import pytest
import torch

from portable_multigrid_tpu_torch.models import poisson
from portable_multigrid_tpu_torch.models.elasticity import ElasticityMultigrid
from portable_multigrid_tpu_torch.programs import (
    geometric_multigrid,
    polynomial_multigrid,
)

MODELS = [poisson._MultigridBase, poisson.GeometricMultigridPoisson,
          poisson.PolynomialMultigridPoisson, ElasticityMultigrid]
PROGRAMS = [
    (geometric_multigrid, "GeometricMultigridPoisson",
     ["--max-degree", "1", "--cycles", "1"]),
    (polynomial_multigrid, "PolynomialMultigridPoisson",
     ["--degree", "2", "--levels", "2", "--cycles", "1"]),
]


@pytest.mark.parametrize("model", MODELS, ids=lambda m: m.__name__)
def test_model_device_defaults_to_cuda(model):
    default = inspect.signature(model.__init__).parameters["device"].default
    assert default == "cuda"


@pytest.mark.parametrize("program,model,argv", PROGRAMS,
                         ids=["geometric", "polynomial"])
def test_program_without_card_fails_loudly(monkeypatch, capsys, program,
                                           model, argv):
    built = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(poisson, model,
                        lambda *a, **k: built.append((a, k)))
    with pytest.raises(SystemExit) as exc:
        program.main(argv)
    assert exc.value.code not in (0, None)
    assert "--device cpu" in str(exc.value.code)
    assert not built
    assert "Solver converged" not in capsys.readouterr().out


@pytest.mark.parametrize("program,model,argv", PROGRAMS,
                         ids=["geometric", "polynomial"])
def test_program_solves_on_cpu_when_asked(monkeypatch, capsys, program,
                                          model, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    program.main(argv + ["--device", "cpu"])
    assert "Solver converged" in capsys.readouterr().out
