from .config import Config, build_parser, parse_opt

__all__ = ["Config", "build_parser", "parse_opt"]
