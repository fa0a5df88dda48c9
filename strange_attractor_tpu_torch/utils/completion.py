"""Shell completion: generation + user-dir install (a copy of the JAX
package's ``strange_attractor_tpu.utils.completion``: importing that module
would import JAX, and this one is stdlib only; tests hold the two to the
same scripts for the same parser).

The reference offers a ``completion`` subcommand via ``clap_autocomplete``
that installs scripts into system shell dirs (root needed, its documented
pain point) or prints with ``--print`` (src/bin/main.rs:370-397,
README.md:57-62). Here the scripts are generated from the argparse parser
definition with *per-option* smarts — value choices (presets, strategies),
file-path completion for output/state flags, and per-subcommand flag sets —
and ``--install`` writes to the per-user completion directories no root can
object to. Every script is keyed on ``parser.prog``, the console script's
name (``strange-attractor-renderer-torch``), which must be one word.
"""

from __future__ import annotations

import argparse
from pathlib import Path

# option dests whose value is a filesystem path -> complete file names
_PATH_DESTS = frozenset({"name", "save_state", "load_state", "profile"})


def _actions(parser: argparse.ArgumentParser):
    """(flag actions, {subcommand: subparser}) of one parser level."""
    opts, subs = [], {}
    for action in parser._actions:  # noqa: SLF001 - argparse has no public API
        if isinstance(action, argparse._SubParsersAction):  # noqa: SLF001
            subs.update(action.choices)
        elif action.option_strings:
            opts.append(action)
    return opts, subs


def _takes_value(action) -> bool:
    return action.nargs != 0


def _value_words(action):
    """Completion candidates for an option's value ('' = free-form,
    None = file path)."""
    if action.choices:
        return [str(c) for c in action.choices]
    if action.dest in _PATH_DESTS:
        return None
    return []


def _bash(prog: str, parser: argparse.ArgumentParser) -> str:
    func = "_" + prog.replace("-", "_")
    top_opts, subs = _actions(parser)

    def words(actions, extra=()):
        out = [o for a in actions for o in a.option_strings]
        return " ".join(out + list(extra))

    def value_cases(actions, indent: str):
        """Per-option value completion cases for ONE parser level — scoped
        per level because flags are NOT globally unique (-s is --scale at
        the top level but --start under sequence)."""
        cases = []
        for action in actions:
            if not _takes_value(action):
                continue
            vals = _value_words(action)
            pat = "|".join(action.option_strings)
            if vals is None:
                cases.append(f'{indent}{pat})\n{indent}  COMPREPLY=( $(compgen -f -- "$cur") ); return;;')
            elif vals:
                cases.append(
                    f'{indent}{pat})\n{indent}  COMPREPLY=( $(compgen -W "{" ".join(vals)}" -- "$cur") ); return;;'
                )
            else:
                cases.append(f"{indent}{pat})\n{indent}  return;;")  # free-form value
        return "\n".join(cases)

    sub_branches = "\n".join(
        f"""    {name})
      case "$prev" in
{value_cases(_actions(sp)[0], "        ")}
      esac
      words="{words(_actions(sp)[0])}";;""" for name, sp in subs.items()
    )
    return f"""{func}() {{
  local cur prev words sub
  cur=${{COMP_WORDS[COMP_CWORD]}}
  prev=${{COMP_WORDS[COMP_CWORD-1]}}
  sub=""
  local i
  for ((i=1; i<COMP_CWORD; i++)); do
    case "${{COMP_WORDS[i]}}" in
      {"|".join(subs) or "__none__"}) sub=${{COMP_WORDS[i]}}; break;;
    esac
  done
  case "$sub" in
{sub_branches}
    *)
      case "$prev" in
{value_cases(top_opts, "        ")}
      esac
      words="{words(top_opts, subs)}";;
  esac
  COMPREPLY=( $(compgen -W "$words" -- "$cur") )
}}
complete -F {func} {prog}
"""


def _esc_zsh(text: str) -> str:
    return (text or "").replace("'", "'\\''").replace("[", "(").replace("]", ")")


def _zsh(prog: str, parser: argparse.ArgumentParser) -> str:
    top_opts, subs = _actions(parser)

    def spec(action) -> str:
        desc = _esc_zsh(action.help)
        if not _takes_value(action):
            tail = f"[{desc}]"
        else:
            vals = _value_words(action)
            if vals is None:
                tail = f"[{desc}]:file:_files"
            elif vals:
                tail = f"[{desc}]:value:({' '.join(vals)})"
            else:
                tail = f"[{desc}]:value:"
        opts = action.option_strings
        if len(opts) == 1:
            return f"  '{opts[0]}{tail}' \\"
        # grouped spec: every alias completes and they exclude each other
        # (emitting only option_strings[-1] dropped all short flags and the
        # canonical --pam/--bmp spellings)
        return f"  '({' '.join(opts)})'{{{','.join(opts)}}}'{tail}' \\"

    lines = [f"#compdef {prog}", "_arguments -s \\"]
    lines += [spec(a) for a in top_opts]
    for name, sp in subs.items():
        lines += [spec(a) for a in _actions(sp)[0]]
    lines.append(f"  '*::subcommand:({' '.join(subs)})'")
    return "\n".join(lines) + "\n"


def _fish(prog: str, parser: argparse.ArgumentParser) -> str:
    top_opts, subs = _actions(parser)

    def lines(actions, cond: str):
        out = []
        for action in actions:
            parts = [f"complete -c {prog}"]
            if cond:
                parts.append(cond)
            for o in action.option_strings:
                parts.append(f"-l {o[2:]}" if o.startswith("--") else f"-s {o[1:]}")
            if action.help:
                parts.append(f"-d '{(action.help or '').split('.')[0][:60].replace(chr(39), '')}'")
            if _takes_value(action):
                vals = _value_words(action)
                if vals is None:
                    parts.append("-r")  # requires an argument; default file completion
                elif vals:
                    parts.append(f"-x -a '{' '.join(vals)}'")
                else:
                    parts.append("-x")
            out.append(" ".join(parts))
        return out

    out = lines(top_opts, f'-n "not __fish_seen_subcommand_from {" ".join(subs)}"' if subs else "")
    for name, sp in subs.items():
        out.append(
            f'complete -c {prog} -n "not __fish_seen_subcommand_from {" ".join(subs)}" -a {name}'
        )
        out += lines(_actions(sp)[0], f'-n "__fish_seen_subcommand_from {name}"')
    return "\n".join(out) + "\n"


def completion_script(shell: str, parser: argparse.ArgumentParser) -> str:
    prog = parser.prog
    if shell == "bash":
        return _bash(prog, parser)
    if shell == "zsh":
        return _zsh(prog, parser)
    if shell == "fish":
        return _fish(prog, parser)
    raise ValueError(f"unsupported shell {shell!r}")


def install_path(shell: str, prog: str, home: Path | None = None) -> Path:
    """Per-user completion file location (no root needed, unlike the
    reference's system-dir install, src/bin/main.rs:389-392)."""
    home = home or Path.home()
    if shell == "bash":
        return home / ".local/share/bash-completion/completions" / prog
    if shell == "zsh":
        return home / ".local/share/zsh/site-functions" / f"_{prog}"
    if shell == "fish":
        return home / ".config/fish/completions" / f"{prog}.fish"
    raise ValueError(f"unsupported shell {shell!r}")


def install_completion(shell: str, parser: argparse.ArgumentParser, home: Path | None = None) -> Path:
    """Write the completion script to the user's completion dir; returns the
    path. zsh users may need the dir on ``fpath``."""
    path = install_path(shell, parser.prog, home)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(completion_script(shell, parser))
    return path
