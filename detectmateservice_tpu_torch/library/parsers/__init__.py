from .template_matcher import MatcherParser, MatcherParserConfig

__all__ = ["MatcherParser", "MatcherParserConfig"]
