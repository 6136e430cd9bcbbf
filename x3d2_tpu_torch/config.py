"""Configuration: Fortran-namelist-compatible .x3d input files (copy of
x3d2_tpu.config).

Reads the reference's input format verbatim (namelist blocks
&domain_settings, &solver_params, &checkpoint_params, &stats_params,
&channel_nml, &cylinder_nml -- reference src/config.f90) so the example
inputs (examples/*/input.x3d) drive the port unchanged:
``Config.from_file(path)``, then ``make_case(cfg)``: ``Mesh.from_config
(cfg.domain)`` and the case ``flow_case_name`` names, from ``cfg.solver``
(the port's SolverParams) and its case block. Unknown keys
warn-and-continue like the reference's optional blocks
(config.f90:316-323).
"""

from __future__ import annotations

import re
import warnings
from dataclasses import dataclass, field, fields as dc_fields


def _parse_value(tok: str):
    tok = tok.strip()
    if not tok:
        return None
    low = tok.lower()
    if low in (".true.", "t", ".t."):
        return True
    if low in (".false.", "f", ".f."):
        return False
    if tok.startswith(("'", '"')) and tok.endswith(("'", '"')):
        return tok[1:-1]
    # fortran float exponents: 1d-3, 2.0D0
    num = re.sub(r"[dD]", "e", tok)
    try:
        if re.fullmatch(r"[+-]?\d+", num):
            return int(num)
        return float(num)
    except ValueError:
        return tok


def _split_values(rhs: str):
    """Split a namelist RHS on commas outside quotes."""
    parts, cur, q = [], "", None
    for ch in rhs:
        if q:
            cur += ch
            if ch == q:
                q = None
        elif ch in "'\"":
            q = ch
            cur += ch
        elif ch == ",":
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    if cur.strip():
        parts.append(cur)
    vals = [_parse_value(p) for p in parts if p.strip()]
    return vals


def parse_namelists(text: str) -> dict[str, dict]:
    """Parse all &block ... / sections into {block: {key: value_or_list}}."""
    # strip comments
    lines = []
    for ln in text.splitlines():
        ln = ln.split("!")[0].rstrip()
        if ln:
            lines.append(ln)
    text = "\n".join(lines)
    blocks = {}
    for m in re.finditer(
            r"&(\w+)(.*?)(?:^/|\n\s*/)", text,
            re.DOTALL | re.MULTILINE | re.IGNORECASE):
        name = m.group(1).lower()
        body = m.group(2)
        # End marker variants: '/', '/End'
        body = re.sub(r"/\s*end\s*$", "", body, flags=re.IGNORECASE)
        entries = {}
        key_pat = r"(\w+(?:\(\d+\))?)"
        for am in re.finditer(
                key_pat + r"\s*=\s*(.*?)(?=\n\s*" + key_pat + r"\s*=|\Z)",
                body, re.DOTALL):
            key = am.group(1).lower()
            vals = _split_values(am.group(2).replace("\n", " "))
            entries[key] = vals[0] if len(vals) == 1 else vals
        blocks[name] = entries
    return blocks


# fortran namelist semantics: indexed entries assign into a defaulted
# array (e.g. pr_species defaults to 1.0 everywhere, config.f90:161)
_INDEXED_PADS = {"pr_species": 1.0}


def _fill(dc, entries: dict, block: str):
    names = {f.name.lower(): f.name for f in dc_fields(dc)}
    defaults = {f.name: getattr(dc, f.name) for f in dc_fields(dc)}
    for k, v in entries.items():
        # fortran indexed assignment: key(i) = value
        m = re.fullmatch(r"(\w+)\((\d+)\)", k)
        if m and m.group(1) in names:
            name = names[m.group(1)]
            idx = int(m.group(2)) - 1
            cur = list(getattr(dc, name))
            # pad skipped slots with the Fortran array default
            pad = _INDEXED_PADS.get(name.lower())
            if pad is None:
                dv = defaults[name]
                pad = dv[-1] if isinstance(dv, tuple) and dv else v
            while len(cur) <= idx:
                cur.append(pad)
            cur[idx] = v
            setattr(dc, name, tuple(cur))
            continue
        if k in names:
            cur = getattr(dc, names[k])
            if isinstance(cur, (tuple, list)) and not isinstance(v, list):
                v = [v]
            if isinstance(cur, tuple):
                v = tuple(v)
            setattr(dc, names[k], v)
        else:
            warnings.warn(f"unknown key '{k}' in &{block}, ignored")
    return dc


@dataclass
class DomainConfig:
    """&domain_settings (config.f90:22-31)."""

    flow_case_name: str = "generic"
    L_global: tuple = (1.0, 1.0, 1.0)
    dims_global: tuple = (16, 16, 16)
    nproc_dir: tuple = (1, 1, 1)
    BC_x: tuple = ("periodic", "periodic")
    BC_y: tuple = ("periodic", "periodic")
    BC_z: tuple = ("periodic", "periodic")
    stretching: tuple = ("uniform", "uniform", "uniform")
    beta: tuple = (1.0, 1.0, 1.0)

    @property
    def BC(self):
        return (self.BC_x, self.BC_y, self.BC_z)


@dataclass
class CheckpointConfig:
    """&checkpoint_params (config.f90:72-85)."""

    checkpoint_freq: int = 0
    snapshot_freq: int = 0
    keep_checkpoint: bool = False
    checkpoint_prefix: str = "checkpoint"
    snapshot_prefix: str = "snapshot"
    restart_from_checkpoint: bool = False
    restart_file: str = ""
    output_stride: tuple = (1, 1, 1)
    snapshot_sp: bool = False
    output_fields: tuple = ()
    # per-shard checkpoint files (io/sharded.py): None = auto (sharded
    # whenever >1 process, so no global field gathers onto host 0 — the
    # reference's per-rank-block rationale, checkpoint_manager.f90:223)
    sharded_io: bool | None = None

    def has_output_field(self, name: str) -> bool:
        return name in tuple(self.output_fields)


@dataclass
class StatsConfig:
    """&stats_params (config.f90:63-70)."""

    initstat: int = 0
    istatfreq: int = 1
    istatout: int = 0
    stats_prefix: str = "statistics"


@dataclass
class ChannelConfig:
    """&channel_nml (config.f90:46-54)."""

    omega_rot: float = 0.0
    init_noise: tuple = (0.0, 0.0, 0.0)
    inlet_noise: tuple = (0.0, 0.0, 0.0)
    rotation: bool = False
    n_rotate: int = 0


@dataclass
class CylinderConfig:
    """&cylinder_nml (config.f90:56-61)."""

    init_noise: tuple = (0.0, 0.0, 0.0)
    inlet_noise: tuple = (0.0, 0.0, 0.0)


@dataclass
class Config:
    """Full parsed input file."""

    domain: DomainConfig = None
    solver: "SolverParams" = None
    checkpoint: CheckpointConfig = None
    stats: StatsConfig = None
    channel: ChannelConfig = None
    cylinder: CylinderConfig = None

    @classmethod
    def from_file(cls, path: str) -> "Config":
        with open(path) as fh:
            return cls.from_string(fh.read())

    @classmethod
    def from_string(cls, text: str) -> "Config":
        from .cases.base import SolverParams

        blocks = parse_namelists(text)
        cfg = cls()
        cfg.domain = _fill(DomainConfig(), blocks.get("domain_settings", {}),
                           "domain_settings")
        sp = SolverParams()
        ent = dict(blocks.get("solver_params", {}))
        nsp = ent.get("n_species", 0)
        if "pr_species" in ent and nsp:
            pr = ent["pr_species"]
            ent["pr_species"] = tuple(pr if isinstance(pr, list)
                                      else [pr])[:nsp]
        cfg.solver = _fill(sp, ent, "solver_params")
        if cfg.solver.n_species:
            # reference semantics (config.f90:194-195): pr_species is a
            # defaulted-1.0 array truncated to n_species
            pr = tuple(cfg.solver.pr_species)[:cfg.solver.n_species]
            pr = pr + (1.0,) * (cfg.solver.n_species - len(pr))
            cfg.solver.pr_species = pr
        cfg.checkpoint = _fill(CheckpointConfig(),
                               blocks.get("checkpoint_params", {}),
                               "checkpoint_params")
        cfg.stats = _fill(StatsConfig(), blocks.get("stats_params", {}),
                          "stats_params")
        if "channel_nml" in blocks:
            cfg.channel = _fill(ChannelConfig(), blocks["channel_nml"],
                                "channel_nml")
        if "cylinder_nml" in blocks:
            cfg.cylinder = _fill(CylinderConfig(), blocks["cylinder_nml"],
                                 "cylinder_nml")
        return cfg


def make_case(cfg: Config, dtype=None, seed=0, verbose=True,
              monitor_path="monitoring.csv", keep_pressure=True,
              device=None):
    """The case factory of x3d2_tpu (__main__.py:15-31; reference
    xcompact.f90:111-126): the mesh from &domain_settings and the case
    ``flow_case_name`` names (tgv; cylinder with &cylinder_nml). Channel
    and generic are not ported yet (ROADMAP Queue 1 item 6) and raise
    NotImplementedError."""
    import torch

    from .cases import CylinderCase, TGVCase
    from .mesh import Mesh

    mesh = Mesh.from_config(cfg.domain)
    name = cfg.domain.flow_case_name.lower()
    if name in ("channel", "generic"):
        raise NotImplementedError(f"the {name} case is not ported yet "
                                  "(ROADMAP Queue 1 item 6)")
    table = {"tgv": (TGVCase, None), "cylinder": (CylinderCase, cfg.cylinder)}
    if name not in table:
        raise ValueError(f"flow_case_name '{name}' is undefined")
    cls, case_cfg = table[name]
    return cls(mesh, cfg.solver, dtype=dtype or torch.float32, seed=seed,
               verbose=verbose, monitor_path=monitor_path,
               keep_pressure=keep_pressure, device=device,
               case_cfg=case_cfg)
